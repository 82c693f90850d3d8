"""DBNet text detector (PyTorch).

Port of ``retto_tpu/models/dbnet.py``: the three backbones ``TpuBackbone``
(:101-125), ``TpuBackboneV2`` (:137-167) and MobileNetV3-large
(``models.mobilenetv3``), the necks ``DBFPN`` (:224-254) and ``ConcatFPN``
(:170-195), the heads ``DBHead`` (:257-279) and ``DBHeadV2`` (:198-221),
and ``DetModel`` (:290-366).  In training (``model.train()``) ``forward``
returns the DB maps ``{"maps", "thresh", "binary"}`` at the head's stride:
the threshold comes from a second head, ``binary = sigmoid(50 (P - T))``.

The model computes in NCHW.  ``nhwc=True`` takes the JAX package's NHWC
input straight from the fused pipeline; every output is NCHW, as in the
JAX model.

The prob map of the engine contract (``forward`` without ``raw_logits``)
follows XLA:CPU's compiled steps: the float32 sigmoid is ``1 / (1 +
exp(-x))`` with XLA's own ``exp`` (:func:`exp_xla`), and the linear
upsample is two passes of two-tap multiply-add chains (:func:`upsample_linear`).
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from .common import (
    ComputeModel,
    Conv,
    ConvBNAct,
    depth_to_space,
    space_to_depth,
    upsample_nearest,
)
from .mobilenetv3 import LARGE_CFG, MobileNetV3

__all__ = [
    "ConcatFPN", "DBFPN", "DBHead", "DBHeadV2", "DetModel", "TpuBackbone",
    "TpuBackboneV2", "exp_xla", "sigmoid_xla", "upsample_linear",
]


def _ftz(x: torch.Tensor) -> torch.Tensor:
    """Flush float32 subnormals to zero, as XLA:CPU's compiled code does."""
    return torch.where(x.abs() < torch.finfo(torch.float32).tiny, torch.zeros_like(x), x)


def _c32(v: float) -> float:
    """A constant as XLA holds it: rounded to float32."""
    return float(torch.tensor(v, dtype=torch.float32))


def _fma(a: torch.Tensor, b, c) -> torch.Tensor:
    """float32 ``a * b + c`` rounded once: the product of two float32 values
    is exact in float64, and so is the sum here."""
    return (a.to(torch.float64) * b + c).to(torch.float32)


_EXP_POLY = tuple(_c32(v) for v in (1.9875691500e-4, 1.3981999507e-3, 8.3334519073e-3,
                                    4.1665795894e-2, 1.6666665459e-1, 5.0000001201e-1))


def exp_xla(x: torch.Tensor) -> torch.Tensor:
    """float32 ``exp`` as XLA:CPU computes it (its Cephes polynomial, with
    every multiply-add fused, as LLVM contracts them): ``n = floor(x*log2(e)
    + 1/2)`` clamped to [-127, 127], ``r = x - n*C1 - n*C2``, a degree-5
    polynomial in ``r``, times ``2**n``, subnormals flushed to zero.  Equal
    to ``jnp.exp`` under ``jax.jit`` on every bfloat16 input
    (tests/test_torch_det_prob_map.py); ``torch.exp`` differs on 494 of them."""
    v = torch.clamp(x.to(torch.float32), _c32(-87.8), _c32(88.8))
    n = torch.floor(_fma(v, _c32(1.44269504088896341), 0.5)).clamp(-127.0, 127.0)
    r = _fma(n, -0.693359375, v)
    r = _fma(n, _c32(2.12194440e-4), r)
    z = _fma(r, _EXP_POLY[0], _EXP_POLY[1])
    for c in _EXP_POLY[2:]:
        z = _fma(z, r, c)
    z = _fma(z, (r * r).to(torch.float64), r) + 1.0
    pow2 = ((n.to(torch.int32) + 127) << 23).view(torch.float32)
    return _ftz(z * pow2)


def sigmoid_xla(x: torch.Tensor) -> torch.Tensor:
    """``nn.sigmoid(x.astype(f32))`` as XLA:CPU compiles it: ``1 / (1 +
    exp(-x))`` in float32 with :func:`exp_xla`, subnormals flushed
    (dbnet.py:221)."""
    return _ftz(torch.reciprocal(exp_xla(-x.float()) + 1.0))


def _linear_pass(x: torch.Tensor, dim: int, factor: int) -> torch.Tensor:
    """Upsample one axis of ``x`` by ``factor`` with ``jax.image.resize``'s
    linear taps (half-pixel centres, the edge tap renormalised to 1).  Each
    output has at most two taps ``k0 < k1``; the sum is XLA's dot as an FMA
    chain in tap order, ``fma(w1, x[k1], w0 * x[k0])``."""
    n = x.shape[dim]
    dev = x.device
    pos = (torch.arange(n * factor, dtype=torch.float64, device=dev) + 0.5) / factor - 0.5
    k0 = torch.floor(pos).clamp(0, n - 1).long()
    k1 = (torch.floor(pos) + 1).clamp(0, n - 1).long()
    w1 = pos - torch.floor(pos)
    w0 = 1.0 - w1
    edge = (pos < 0) | (pos > n - 1)
    w0 = torch.where(edge, torch.ones_like(w0), w0)
    w1 = torch.where(edge, torch.zeros_like(w1), w1)
    shape = [1] * x.dim()
    shape[dim] = -1
    w0, w1 = w0.to(torch.float32).reshape(shape), w1.reshape(shape)
    a = (x.index_select(dim, k0) * w0).to(torch.float64)
    return (x.index_select(dim, k1).to(torch.float64) * w1 + a).to(torch.float32)


def upsample_linear(x: torch.Tensor, factor: int) -> torch.Tensor:
    """``jax.image.resize(method="linear")`` upsampling of float32 NCHW by an
    integer factor (dbnet.py:356-360): the H pass, then the W pass, each an
    FMA chain over its two taps.  XLA:CPU's dot emitter picks its own order
    per shape; this one is XLA's bit for bit at small maps and on all but
    ~0.02% of a [512, 384] map's outputs (tests/test_torch_det_prob_map.py)."""
    return _linear_pass(_linear_pass(x.float(), 2, factor), 3, factor)


class TpuResBlock(nn.Module):
    """Two dense 3x3 convs with a residual skip (dbnet.py:86-98)."""

    def __init__(self, ch: int):
        super().__init__()
        self.ConvBNAct_0 = ConvBNAct(ch, ch, 3, 1, act="relu")
        self.ConvBNAct_1 = ConvBNAct(ch, ch, 3, 1, act="none")

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.relu(x + self.ConvBNAct_1(self.ConvBNAct_0(x)))


class TpuBackboneV2(nn.Module):
    """8x8 space-to-depth stem, then stages at strides 8/16/32, each a
    ConvBNAct (stride 1 on the stem, else 2) and ``depths[i]`` residual
    blocks (dbnet.py:137-167).  ``TpuBackbone`` is the same with a 4x4 stem
    and four stages at strides 4/8/16/32 (dbnet.py:101-125)."""

    block = 8

    def __init__(self, widths: Sequence[int] = (128, 256, 384),
                 depths: Sequence[int] = (1, 1, 1)):
        super().__init__()
        self.stages: list[list[str]] = []
        c, k = 3 * self.block * self.block, 0  # RGB after the space-to-depth
        for i, (w, d) in enumerate(zip(widths, depths)):
            names = [f"ConvBNAct_{i}"]
            setattr(self, names[0], ConvBNAct(c, w, 3, 1 if i == 0 else 2, act="relu"))
            for _ in range(d):
                names.append(f"TpuResBlock_{k}")
                setattr(self, names[-1], TpuResBlock(w))
                k += 1
            self.stages.append(names)
            c = w

    def forward(self, x: torch.Tensor) -> list[torch.Tensor]:
        x = space_to_depth(x, self.block)
        feats = []
        for names in self.stages:
            for name in names:
                x = getattr(self, name)(x)
            feats.append(x)
        return feats


class TpuBackbone(TpuBackboneV2):
    """Dense-conv backbone: 4x4 space-to-depth stem, strides 4/8/16/32
    (dbnet.py:101-125)."""

    block = 4

    def __init__(self, widths: Sequence[int] = (64, 128, 192, 256),
                 depths: Sequence[int] = (1, 2, 2, 2)):
        super().__init__(widths, depths)


class ConcatFPN(nn.Module):
    """1x1 laterals, nearest top-down adds, upsample-to-finest concat
    (dbnet.py:170-195)."""

    def __init__(self, in_chs: Sequence[int], inner_ch: int = 128):
        super().__init__()
        self.n = len(in_chs)
        for i, c in enumerate(in_chs):
            setattr(self, f"Conv_{i}", Conv(c, inner_ch, 1, bias=False))

    def forward(self, feats: Sequence[torch.Tensor]) -> torch.Tensor:
        ins = [getattr(self, f"Conv_{i}")(f) for i, f in enumerate(feats)]
        tops = [ins[-1]]
        for f in reversed(ins[:-1]):
            tops.append(f + upsample_nearest(tops[-1], 2))
        tops.reverse()  # finest first
        return torch.cat([upsample_nearest(t, 1 << i) for i, t in enumerate(tops)], dim=1)


class DBHeadV2(nn.Module):
    """3x3 conv at the feature stride, 1x1 to (feature_stride/out_stride)^2
    logit channels, depth-to-space to the ``out_stride`` map
    (dbnet.py:198-221)."""

    def __init__(self, in_ch: int, mid_ch: int = 128, out_stride: int = 2,
                 feature_stride: int = 8):
        super().__init__()
        self.factor = feature_stride // out_stride
        self.ConvBNAct_0 = ConvBNAct(in_ch, mid_ch, 3, 1, act="relu")
        self.Conv_0 = Conv(mid_ch, self.factor * self.factor, 1)

    def forward(self, x: torch.Tensor, return_logits: bool = False) -> torch.Tensor:
        logit = self.Conv_0(self.ConvBNAct_0(x))
        if self.factor > 1:
            logit = depth_to_space(logit, self.factor)
        if return_logits:
            return logit
        return torch.sigmoid(logit.float()) if self.training else sigmoid_xla(logit)


class DBFPN(nn.Module):
    """Top-down FPN with concat fuse (dbnet.py:224-254): 1x1 laterals to
    ``inner_ch``, nearest top-down adds, a 3x3 conv per level to ``out_ch``,
    all brought to stride 4 and concatenated."""

    def __init__(self, in_chs: Sequence[int], inner_ch: int = 96, out_ch: int = 24):
        super().__init__()
        for i, c in enumerate(in_chs):
            setattr(self, f"Conv_{i}", Conv(c, inner_ch, 1, bias=False))
        for i in range(4):
            setattr(self, f"Conv_{4 + i}", Conv(inner_ch, out_ch, 3, bias=False))

    def forward(self, feats: Sequence[torch.Tensor]) -> torch.Tensor:
        ins = [getattr(self, f"Conv_{i}")(f) for i, f in enumerate(feats)]
        p5 = ins[3]
        p4 = ins[2] + upsample_nearest(p5, 2)
        p3 = ins[1] + upsample_nearest(p4, 2)
        p2 = ins[0] + upsample_nearest(p3, 2)
        outs = [getattr(self, f"Conv_{4 + i}")(p) for i, p in enumerate((p2, p3, p4, p5))]
        return torch.cat([upsample_nearest(o, 1 << i) for i, o in enumerate(outs)], dim=1)


class DBHead(nn.Module):
    """3x3 ConvBNAct and a 1x1 to one logit channel at stride 4, the logits
    upsampled bilinearly to ``out_stride`` (dbnet.py:257-279)."""

    def __init__(self, in_ch: int, mid_ch: int = 64, out_stride: int = 2):
        super().__init__()
        self.factor = 4 // out_stride
        self.ConvBNAct_0 = ConvBNAct(in_ch, mid_ch, 3, 1, act="relu")
        self.Conv_0 = Conv(mid_ch, 1, 1)

    def forward(self, x: torch.Tensor, return_logits: bool = False) -> torch.Tensor:
        logit = self.Conv_0(self.ConvBNAct_0(x))
        if self.factor > 1:  # _upsample_bilinear (dbnet.py:65-71)
            logit = upsample_linear(logit, self.factor).to(logit.dtype)
        if return_logits:
            return logit
        return torch.sigmoid(logit.float()) if self.training else sigmoid_xla(logit)


class DetModel(ComputeModel):
    """Full DBNet.  In inference ``forward`` returns the [N, 1, H, W] prob map
    (f32, upsampled from the stride-``out_stride`` head, the engine
    contract); ``raw_logits=True`` returns the stride-s LOGITS in the
    compute dtype, which the fused pipeline thresholds in logit space (dbnet.py:340-348).  In training it returns
    the dict of stride-s DB maps (dbnet.py:361-366).

    The second head (``DBHeadV2_1`` / ``DBHead_1``) is the threshold head:
    the module always holds it, and inference never runs it.  A checkpoint
    of a Flax model initialised for inference lacks it, so loading leaves
    it at its initial values (``optional_state``)."""

    optional_state = ("DBHead_1.", "DBHeadV2_1.")

    def __init__(self, backbone: str = "tpu", backbone_scale: float = 0.5,
                 widths: Sequence[int] = (64, 128, 192, 256),
                 depths: Sequence[int] = (1, 2, 2, 2), inner_ch: int = 96,
                 head_ch: int = 64, out_stride: int = 2,
                 dtype: torch.dtype | None = None):
        super().__init__(dtype)
        self.backbone = backbone
        self.out_stride = out_stride
        if backbone == "tpu_v2":
            self.TpuBackboneV2_0 = TpuBackboneV2(widths, depths)
            self.ConcatFPN_0 = ConcatFPN(widths, inner_ch)
            fused_ch = inner_ch * len(widths)
            self.heads = ("DBHeadV2_0", "DBHeadV2_1")
            for name in self.heads:
                setattr(self, name, DBHeadV2(fused_ch, head_ch, out_stride))
        else:
            if backbone == "tpu":
                self.TpuBackbone_0 = TpuBackbone(widths, depths)
                chs = tuple(widths)
            elif backbone == "mobilenetv3":
                self.MobileNetV3_0 = MobileNetV3(LARGE_CFG, backbone_scale, last_ch=960,
                                                 feature_strides=(4, 8, 16, 32))
                chs = self.MobileNetV3_0.feature_channels
            else:
                raise ValueError(f"unknown det backbone {backbone!r}")
            self.DBFPN_0 = DBFPN(chs, inner_ch, inner_ch // 4)
            self.heads = ("DBHead_0", "DBHead_1")
            for name in self.heads:
                setattr(self, name, DBHead(inner_ch, head_ch, out_stride))
        self.finish_init()

    def forward(self, x: torch.Tensor, nhwc: bool = False, raw_logits: bool = False):
        if nhwc:
            x = x.permute(0, 3, 1, 2)
        if self.compute_dtype is not None:
            x = x.to(self.compute_dtype)
        if self.backbone == "tpu_v2":
            fused = self.ConcatFPN_0(self.TpuBackboneV2_0(x))
        elif self.backbone == "tpu":
            fused = self.DBFPN_0(self.TpuBackbone_0(x))
        else:
            fused = self.DBFPN_0(self.MobileNetV3_0(x))
        head, thresh_head = (getattr(self, name) for name in self.heads)
        if raw_logits and not self.training:
            return head(fused, return_logits=True)
        prob = head(fused)
        if not self.training:
            if self.out_stride > 1:
                prob = upsample_linear(prob, self.out_stride)
            return prob
        thresh = thresh_head(fused)
        # differentiable binarization: B = sigmoid(k (P - T)), k = 50
        return {"maps": prob, "thresh": thresh,
                "binary": torch.sigmoid(50.0 * (prob - thresh))}
