"""SVTR-LCNet text recognizer with CTC output (PyTorch).

Port of ``retto_tpu/models/svtr.py``.  Engine contract (worker.rs:72):
NCHW f32 [N, 3, H, W] -> per-timestep class probabilities f32 [N, T, C],
T = W / 8.

Parity traps pinned by tests/test_torch_models.py: SAME padding of the
(2, 1)-strided stage pads rows (0, 1) and columns (1, 1) (svtr.py:70);
GELU is the tanh approximation (svtr.py:102); LayerNorm eps is 1e-6
(svtr.py:95, :100, :129).
"""

from __future__ import annotations

import math
from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from .common import (
    ACTIVATIONS,
    HARD_SWISH_SCALE,
    ComputeModel,
    ConvBNAct,
    Dense,
    LayerNorm,
    SEModule,
    mean_f32,
    xla_hw_sum,
)

__all__ = ["DSConv", "LCNetBackbone", "MultiHeadDotProductAttention", "SVTRBlock",
           "RecModel"]


class DSConv(nn.Module):
    """Depthwise-separable conv block (svtr.py:27-47)."""

    def __init__(self, in_ch: int, out_ch: int, stride=1, use_se: bool = False):
        super().__init__()
        self.ConvBNAct_0 = ConvBNAct(in_ch, in_ch, 3, stride, groups=in_ch,
                                     act="hardswish")
        self.use_se = use_se
        if use_se:
            self.SEModule_0 = SEModule(in_ch)
        self.ConvBNAct_1 = ConvBNAct(in_ch, out_ch, 1, 1, act="hardswish")
        self.ConvBNAct_1.Conv_0.xla_dot = True  # an HLO dot in the compiled rec

    def forward(self, x: torch.Tensor, keep_f32: bool = False):
        """``keep_f32``: also return the last activation's float32 product
        (``ConvBNAct``), which the LCNet's final mean reads."""
        if self.use_se and not x.is_cuda and not self.training:
            # the SE gate's mean reads the unrounded product (SEModule)
            x = self.SEModule_0(*self.ConvBNAct_0(x, keep_f32=True))
        else:
            x = self.ConvBNAct_0(x)
            if self.use_se:
                x = self.SEModule_0(x)
        return self.ConvBNAct_1(x, keep_f32=keep_f32)


class LCNetBackbone(nn.Module):
    """Stem (2,2), stages (2,2), (2,2), (2,1), (1,1), then the mean over the
    remaining height -> [N, W/8, C] (svtr.py:50-84)."""

    def __init__(self, dims: Sequence[int] = (64, 128, 256, 512),
                 depths: Sequence[int] = (2, 2, 2, 2)):
        super().__init__()
        self.ConvBNAct_0 = ConvBNAct(3, dims[0] // 2, 3, 2, act="hardswish")
        strides = [(2, 2), (2, 2), (2, 1), (1, 1)]
        self.blocks: list[str] = []
        c = dims[0] // 2
        for dim, depth, stride in zip(dims, depths, strides):
            for i in range(depth):
                name = f"DSConv_{len(self.blocks)}"
                setattr(self, name, DSConv(c, dim, stride if i == 0 else 1,
                                           use_se=(i == depth - 1)))
                self.blocks.append(name)
                c = dim

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """On the CPU in inference the final mean reads the last block's
        unrounded hard-swish product and sums the height in XLA:CPU's order
        with the 1/6 fused in (``models.common.xla_hw_sum``), as the
        compiled Flax model does."""
        x = self.ConvBNAct_0(x)
        for name in self.blocks[:-1]:
            x = getattr(self, name)(x)
        if x.is_cuda or self.training:
            x = getattr(self, self.blocks[-1])(x)
            return mean_f32(x, 2).squeeze(2).to(x.dtype).transpose(1, 2)
        x, x32 = getattr(self, self.blocks[-1])(x, keep_f32=True)
        mean = xla_hw_sum(x32.transpose(2, 3)[..., None], HARD_SWISH_SCALE) * (1.0 / x.shape[2])
        return mean.to(x.dtype).transpose(1, 2)


def _xla_row_sum(x: torch.Tensor) -> torch.Tensor:
    """Sum over the last axis in XLA:CPU's order: ``xla_hw_sum`` over one
    row (windows of 32 over the zero-padded axis, then the windows)."""
    return xla_hw_sum(x.unsqueeze(-2))


class MultiHeadDotProductAttention(nn.Module):
    """Flax ``nn.MultiHeadDotProductAttention`` self-attention: the q/k/v
    ``DenseGeneral`` kernels [D, H, Dh] stacked into ``in_proj_weight``
    [3D, D], the output kernel [H, Dh, D] as ``out_proj`` [D, D].  Queries
    are scaled by 1/sqrt(Dh) before the product and the softmax runs over
    keys, as in flax's ``dot_product_attention``."""

    compute_cast = True  # models.common.cast_compute casts in_proj too
    compute_dtype: torch.dtype | None = None

    def __init__(self, dim: int, num_heads: int):
        super().__init__()
        self.num_heads = num_heads
        self.in_proj_weight = nn.Parameter(torch.empty(3 * dim, dim))
        self.in_proj_bias = nn.Parameter(torch.zeros(3 * dim))
        self.out_proj = Dense(dim, dim)
        nn.init.xavier_uniform_(self.in_proj_weight)
        self.training = False

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        n, t, d = x.shape
        h = self.num_heads
        dh = d // h
        dt = self.compute_dtype or self.in_proj_weight.dtype
        # the product rounds before the bias add, as in Flax's DenseGeneral
        qkv = F.linear(x.to(dt), self.in_proj_weight.to(dt)) + self.in_proj_bias.to(dt)
        q, k, v = (z.reshape(n, t, h, dh) for z in qkv.split(d, dim=-1))
        return self.out_proj(self.attend(q, k, v, fixed_order=not self.training)
                             .reshape(n, t, d))

    @staticmethod
    def attend(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
               fixed_order: bool = True) -> torch.Tensor:
        """[N, T, H, Dh] q, k, v -> [N, T, H, Dh]: flax's
        ``dot_product_attention`` as XLA:CPU compiles it.  The query is
        multiplied by float32(1 / sqrt(Dh) in the compute dtype) and
        rounded; the softmax subtracts the max in the compute dtype, sums
        the float32 exps unrounded and divides the rounded exps by the
        rounded sum.

        On the CPU both products and the softmax sum are float32 sums in
        one fixed order, so the bits do not depend on the intra-op thread
        count or on the kernel a library picks: the products term by term
        over Dh and over keys (products of compute-dtype values are exact
        in float32), the exps in XLA's windows (``_xla_row_sum``).  On the
        card, and in training (``fixed_order=False``), the products run on
        the BLAS."""
        dh = q.shape[-1]
        inv = 1.0 / float(torch.tensor(math.sqrt(dh), dtype=q.dtype))
        q = (q.float() * inv).to(q.dtype)
        if q.is_cuda or not fixed_order:
            w = torch.einsum("nqhd,nkhd->nhqk", q, k)
            e = torch.exp((w - w.amax(dim=-1, keepdim=True)).float())
            w = e.to(q.dtype) / e.sum(dim=-1, keepdim=True).to(q.dtype)
            return torch.einsum("nhqk,nkhd->nqhd", w, v)
        qh = q.float().permute(0, 2, 1, 3)  # [N, H, Tq, Dh]
        kh = k.float().permute(0, 2, 1, 3)  # [N, H, Tk, Dh]
        vh = v.float().permute(0, 2, 1, 3)
        w = qh[..., :, None, 0] * kh[..., None, :, 0]
        for d in range(1, dh):
            w = w + qh[..., :, None, d] * kh[..., None, :, d]
        w = w.to(q.dtype)
        e = torch.exp((w - w.amax(dim=-1, keepdim=True)).float())
        p = (e.to(q.dtype) / _xla_row_sum(e)[..., None].to(q.dtype)).float()
        out = p[..., :, 0, None] * vh[..., None, 0, :]
        for j in range(1, vh.shape[2]):
            out = out + p[..., :, j, None] * vh[..., None, j, :]
        return out.to(q.dtype).permute(0, 2, 1, 3)


class SVTRBlock(nn.Module):
    """Pre-norm global mixing block: LN -> MHSA -> LN -> MLP
    (svtr.py:87-106).

    ``forward(x, x32)`` takes the block input twice: rounded to the compute
    dtype (``x``, what the residual adds read) and as the float32 sum it was
    rounded from (``x32``, what the LayerNorm reads).  XLA:CPU hands each
    LayerNorm the unrounded float32 output of the bias or residual add
    before it, and the next residual add the rounded one; the block returns
    both for its output."""

    def __init__(self, dim: int, num_heads: int = 8, mlp_ratio: float = 2.0):
        super().__init__()
        self.LayerNorm_0 = LayerNorm(dim)
        self.MultiHeadDotProductAttention_0 = MultiHeadDotProductAttention(dim, num_heads)
        self.LayerNorm_1 = LayerNorm(dim)
        hidden = int(dim * mlp_ratio)
        self.Dense_0 = Dense(dim, hidden)
        self.Dense_1 = Dense(hidden, dim)

    def forward(self, x: torch.Tensor, x32: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        dt = x.dtype
        y = self.MultiHeadDotProductAttention_0(self.LayerNorm_0(x32).to(dt))
        x32 = x.float() + y.float()
        x = x32.to(dt)
        y = ACTIVATIONS["gelu"](self.Dense_0(self.LayerNorm_1(x32).to(dt)))
        x32 = x.float() + self.Dense_1(y).float()
        return x32.to(dt), x32


class RecModel(ComputeModel):
    """LCNet backbone -> SVTR mixer -> CTC head (svtr.py:109-134).
    ``return_logits`` returns the float32 logits the CTC loss takes."""

    def __init__(self, num_classes: int = 6625,
                 dims: Sequence[int] = (64, 128, 256, 512),
                 depths: Sequence[int] = (2, 2, 2, 2), mixer_dim: int = 120,
                 mixer_depth: int = 2, num_heads: int = 8,
                 dtype: torch.dtype | None = None):
        super().__init__(dtype)
        self.LCNetBackbone_0 = LCNetBackbone(dims, depths)
        self.Dense_0 = Dense(dims[-1], mixer_dim)
        self.mixer = [f"SVTRBlock_{i}" for i in range(mixer_depth)]
        for name in self.mixer:
            setattr(self, name, SVTRBlock(mixer_dim, num_heads))
        self.LayerNorm_0 = LayerNorm(mixer_dim)
        self.Dense_1 = Dense(mixer_dim, num_classes)
        self.finish_init()

    def forward(self, x: torch.Tensor, return_logits: bool = False) -> torch.Tensor:
        feats = self.LCNetBackbone_0(x)
        seq32 = self.Dense_0(feats, f32_out=True)
        seq = seq32.to(feats.dtype)
        for name in self.mixer:
            seq, seq32 = getattr(self, name)(seq, seq32)
        logits = self.Dense_1(self.LayerNorm_0(seq32).to(seq.dtype), f32_out=True)
        if return_logits:
            return logits
        return torch.softmax(logits, dim=-1)
