"""Shared building blocks for the PP-OCR model families (PyTorch).

Port of ``retto_tpu/models/common.py``.  Modules compute in NCHW (PyTorch's
layout); the model classes keep the JAX package's layout at their public
boundary.  Submodules carry the Flax scope names (``Conv_0``,
``BatchNorm_0``, ...) as attribute names, so a Flax checkpoint key maps onto
a state-dict key by one rule (``weights/convert.py``).

Precision follows Flax: a Conv or Dense casts its input and its parameters
to the compute dtype (bf16 for the shipped presets) and returns that dtype;
BatchNorm and LayerNorm compute in float32 and cast back.  Elementwise
ops (hard-swish, GELU, the SE gate) run op by op in the compute dtype, so
bf16 rounds after each op as in the JAX model.
"""

from __future__ import annotations

import math
from typing import Callable

import torch
import torch.nn.functional as F
from torch import nn

__all__ = [
    "hard_sigmoid",
    "hard_swish",
    "ACTIVATIONS",
    "Conv",
    "Dense",
    "BatchNorm",
    "LayerNorm",
    "ConvBNAct",
    "SEModule",
    "space_to_depth",
    "depth_to_space",
    "upsample_nearest",
    "cast_compute",
]


def hard_sigmoid(x: torch.Tensor, slope: float = 0.2, offset: float = 0.5) -> torch.Tensor:
    """Paddle-style hard sigmoid (common.py:37-40)."""
    return torch.clamp(x * slope + offset, 0.0, 1.0)


def hard_swish(x: torch.Tensor) -> torch.Tensor:
    return x * torch.clamp(x + 3.0, 0.0, 6.0) / 6.0


def gelu_tanh(x: torch.Tensor) -> torch.Tensor:
    """``flax.linen.gelu`` (approximate=True, the tanh form; svtr.py:102),
    written out op by op so that bf16 rounds where JAX rounds."""
    cdf = 0.5 * (1.0 + torch.tanh(math.sqrt(2.0 / math.pi) * (x + 0.044715 * x ** 3)))
    return x * cdf


ACTIVATIONS: dict[str, Callable[[torch.Tensor], torch.Tensor]] = {
    "relu": F.relu,
    "hardswish": hard_swish,
    "gelu": gelu_tanh,
    "none": lambda x: x,
}


def _pair(v: int | tuple[int, int]) -> tuple[int, int]:
    return v if isinstance(v, tuple) else (v, v)


def _same_pads(size: int, k: int, s: int) -> tuple[int, int]:
    """Flax/TF ``padding="SAME"``: the odd pixel of padding goes AFTER, so a
    stride-2 3x3 conv on an even extent pads (0, 1), not (1, 1)
    (common.py:72-80)."""
    out = -(-size // s)
    total = max((out - 1) * s + k - size, 0)
    return total // 2, total - total // 2


class Conv(nn.Conv2d):
    """``nn.Conv(padding="SAME")`` in NCHW: input and parameters are cast to
    the parameter dtype (the compute dtype once the model is cast)."""

    def __init__(self, in_ch: int, out_ch: int, kernel=1, stride=1, groups: int = 1,
                 bias: bool = True):
        super().__init__(in_ch, out_ch, _pair(kernel), _pair(stride), padding=0,
                         groups=groups, bias=bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        (kh, kw), (sh, sw) = self.kernel_size, self.stride
        ph = _same_pads(x.shape[2], kh, sh)
        pw = _same_pads(x.shape[3], kw, sw)
        x = x.to(self.weight.dtype)
        if ph[0] == ph[1] and pw[0] == pw[1]:
            return F.conv2d(x, self.weight, self.bias, self.stride, (ph[0], pw[0]),
                            groups=self.groups)
        x = F.pad(x, (pw[0], pw[1], ph[0], ph[1]))
        return F.conv2d(x, self.weight, self.bias, self.stride, 0, groups=self.groups)


class Dense(nn.Linear):
    """``nn.Dense``: input cast to the parameter dtype."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.linear(x.to(self.weight.dtype), self.weight, self.bias)


class BatchNorm(nn.Module):
    """Inference BatchNorm with Flax's arithmetic (flax ``_normalize``):
    ``(x - mean) * (rsqrt(var + eps) * scale) + bias`` in float32, cast back
    to the input dtype.  eps 1e-5 (common.py:81-83)."""

    def __init__(self, ch: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(ch))
        self.bias = nn.Parameter(torch.zeros(ch))
        self.register_buffer("running_mean", torch.zeros(ch))
        self.register_buffer("running_var", torch.ones(ch))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        mul = torch.rsqrt(self.running_var.float() + self.eps) * self.weight.float()
        y = (x.float() - self.running_mean.float()[:, None, None]) * mul[:, None, None]
        return (y + self.bias.float()[:, None, None]).to(x.dtype)


class LayerNorm(nn.Module):
    """Flax ``nn.LayerNorm`` over the last axis: eps **1e-6** (svtr.py:95),
    statistics and affine in float32, cast back to the input dtype."""

    def __init__(self, dim: int, eps: float = 1e-6):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(dim))
        self.bias = nn.Parameter(torch.zeros(dim))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.layer_norm(x.float(), (x.shape[-1],), self.weight.float(),
                         self.bias.float(), self.eps)
        return y.to(x.dtype)


class ConvBNAct(nn.Module):
    """Conv (no bias) + BatchNorm + activation (common.py:59-84)."""

    def __init__(self, in_ch: int, out_ch: int, kernel=3, stride=1, groups: int = 1,
                 act: str = "hardswish"):
        super().__init__()
        self.Conv_0 = Conv(in_ch, out_ch, kernel, stride, groups, bias=False)
        self.BatchNorm_0 = BatchNorm(out_ch)
        self.act = act

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return ACTIVATIONS[self.act](self.BatchNorm_0(self.Conv_0(x)))


class SEModule(nn.Module):
    """Squeeze-and-excitation with the Paddle hard-sigmoid gate
    (common.py:87-100)."""

    def __init__(self, ch: int, reduction: int = 4):
        super().__init__()
        self.Conv_0 = Conv(ch, max(ch // reduction, 1), 1)
        self.Conv_1 = Conv(max(ch // reduction, 1), ch, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        s = x.float().mean(dim=(2, 3), keepdim=True).to(x.dtype)
        s = self.Conv_1(F.relu(self.Conv_0(s)))
        return x * hard_sigmoid(s)


def space_to_depth(x: torch.Tensor, block: int) -> torch.Tensor:
    """NCHW [N,C,H,W] -> [N,C*b*b,H/b,W/b] with the JAX package's NHWC
    channel order (dbnet.py:74-83): channel ``(by*b + bx)*C + c``.
    (``F.pixel_unshuffle`` orders ``c*b*b + by*b + bx`` and does not match.)"""
    n, c, h, w = x.shape
    x = x.reshape(n, c, h // block, block, w // block, block)
    x = x.permute(0, 3, 5, 1, 2, 4)
    return x.reshape(n, block * block * c, h // block, w // block)


def depth_to_space(x: torch.Tensor, block: int) -> torch.Tensor:
    """Inverse of :func:`space_to_depth` (dbnet.py:127-135)."""
    n, c, h, w = x.shape
    co = c // (block * block)
    x = x.reshape(n, block, block, co, h, w)
    x = x.permute(0, 3, 4, 1, 5, 2)
    return x.reshape(n, co, h * block, w * block)


def upsample_nearest(x: torch.Tensor, factor: int) -> torch.Tensor:
    """Nearest-neighbour upsample by an integer factor (dbnet.py:55-62)."""
    if factor == 1:
        return x
    return x.repeat_interleave(factor, dim=2).repeat_interleave(factor, dim=3)


def cast_compute(module: nn.Module, dtype: torch.dtype | None) -> nn.Module:
    """Cast the parameters of every Conv, Dense and attention projection to
    the compute dtype (Flax casts them per call; casting once is the same
    arithmetic).  BatchNorm and LayerNorm keep float32 parameters."""
    if dtype is None or dtype == torch.float32:
        return module
    for m in module.modules():
        if isinstance(m, (Conv, Dense)) or getattr(m, "compute_cast", False):
            for p in m.parameters(recurse=False):
                p.data = p.data.to(dtype)
    return module
