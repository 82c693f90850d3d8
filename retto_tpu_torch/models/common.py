"""Shared building blocks for the PP-OCR model families (PyTorch).

Port of ``retto_tpu/models/common.py``.  Modules compute in NCHW (PyTorch's
layout); the model classes keep the JAX package's layout at their public
boundary.  Submodules carry the Flax scope names (``Conv_0``,
``BatchNorm_0``, ...) as attribute names, so a Flax checkpoint key maps onto
a state-dict key by one rule (``weights/convert.py``).

Precision follows Flax as XLA compiles it: a Conv or Dense casts its input
and its parameters to the compute dtype (bf16 for the shipped presets) and
returns that dtype; BatchNorm and LayerNorm compute in float32 and cast
back.  One exception: XLA drops the bf16 rounding of a convolution whose
only consumer converts it to float32, which is every ``ConvBNAct`` conv
(the BatchNorm's first step), so there the conv runs in float32 on the
compute-dtype values and the BatchNorm rounds once.  Every other conv and
every Dense keeps its rounding (a bias add or a residual add consumes it
in bf16); tests/test_torch_bf16_sites.py reads the sites from XLA's
compiled HLO.  Elementwise ops (hard-swish, GELU, the SE gate) run op by
op in the compute dtype, so bf16 rounds after each op as in the JAX model.

On the CPU the dense convs and the BatchNorm also take XLA:CPU's
arithmetic (the native ``conv_xla`` and ``rsqrt_xla``): the conv sums in
Eigen's blocked order of fused multiply-adds, the BatchNorm multiplies by
XLA's ``rsqrt`` and fuses its multiply and add.  With them the mobile det
matches the jitted Flax model bit for bit on the fixture pages but for 1
of 196,608 logits (tests/test_torch_det_parity.py).  A depthwise conv
(``groups == C``) sums its taps in the fixed tree XLA:CPU's Eigen
contraction uses (:data:`_DW_TREES`).  CUDA tensors take cuDNN either way.

Training (``module.train()``) keeps the parameters in float32 and casts
each Conv, Dense and attention weight to the compute dtype at the call, as
Flax's ``param_dtype=float32, dtype=bfloat16`` does; BatchNorm then
normalises by the batch's statistics and updates its running ones with
Flax's momentum.  In training every op is a differentiable torch op: the
CPU paths in XLA:CPU's order above serve inference only.  Every module
starts in inference mode.
"""

from __future__ import annotations

import contextlib
import math
import threading
from typing import Callable, Iterator

import torch
import torch.nn.functional as F
from torch import nn

__all__ = [
    "make_divisible",
    "hard_sigmoid",
    "hard_swish",
    "mean_f32",
    "xla_hw_sum",
    "xla_dot",
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
    "set_compute_dtype",
    "ComputeModel",
    "full_float32",
]


def make_divisible(v: float, divisor: int = 8, min_value: int | None = None) -> int:
    """Round channel counts to a multiple of ``divisor`` (MobileNet rule,
    common.py:27-34)."""
    if min_value is None:
        min_value = divisor
    new_v = max(min_value, int(v + divisor / 2) // divisor * divisor)
    if new_v < 0.9 * v:
        new_v += divisor
    return new_v


def _const(v: float, like: torch.Tensor) -> float:
    """A Python constant as JAX sees it beside an array: a weakly typed
    scalar takes the array's dtype (bf16(0.2) = 0.2001953125)."""
    return float(torch.tensor(v, dtype=like.dtype))


def hard_sigmoid(x: torch.Tensor, slope: float = 0.2, offset: float = 0.5) -> torch.Tensor:
    """Paddle-style hard sigmoid (common.py:37-40)."""
    return torch.clamp(x * _const(slope, x) + _const(offset, x), 0.0, 1.0)


HARD_SWISH_SCALE = float(torch.tensor(1.0 / 6.0))  # float32(1/6)


def hard_swish(x: torch.Tensor) -> torch.Tensor:
    """``x * clip(x + 3, 0, 6) / 6``; XLA turns the division by the constant
    into a multiply by float32(1/6)."""
    return x * torch.clamp(x + 3.0, 0.0, 6.0) * (1.0 / 6.0)


def gelu_tanh(x: torch.Tensor) -> torch.Tensor:
    """``flax.linen.gelu`` (approximate=True, the tanh form; svtr.py:102),
    written out op by op so that bf16 rounds where XLA rounds: the
    constants in the compute dtype, ``x**3`` as ``(x * x) * x``."""
    inner = _const(math.sqrt(2.0 / math.pi), x) * (x + _const(0.044715, x) * (x * x * x))
    cdf = 0.5 * (1.0 + torch.tanh(inner))
    return x * cdf


def mean_f32(x: torch.Tensor, dim) -> torch.Tensor:
    """``jnp.mean`` as XLA computes it: a float32 sum times float32(1/n)."""
    dims = (dim,) if isinstance(dim, int) else tuple(dim)
    n = math.prod(x.shape[d] for d in dims)
    return x.float().sum(dim=dims, keepdim=True) * (1.0 / n)


def _sum_in_order(x: torch.Tensor, scale: float | None = None) -> torch.Tensor:
    """Float32 sum over the last axis, term by term from +0.  With ``scale``
    each step is one fused multiply-add, ``s = fma(x_i, scale, s)``: the
    product of a bf16 value and a float32 scale is exact in float64, so one
    rounding of the float64 sum gives the fused result."""
    if scale is None:
        s = x[..., 0] + 0.0
        for i in range(1, x.shape[-1]):
            s = s + x[..., i]
        return s
    x = x.double()
    s = (x[..., 0] * scale).float()
    for i in range(1, x.shape[-1]):
        s = (x[..., i] * scale + s.double()).float()
    return s


def xla_hw_sum(x: torch.Tensor, scale: float | None = None, window: int = 32
               ) -> torch.Tensor:
    """float32 sum of [..., H, W] over (H, W) in XLA:CPU's order (its tree
    reduction rewriter, read from the compiled HLO): when an axis exceeds
    ``window``, that axis is zero-padded evenly (the odd element after) to a
    multiple of ``window`` and cut into windows of ``window``, an axis of
    ``window`` or fewer is one window; each window sums its (h, w) terms row
    by row, term by term, and the windows' sums are summed the same way.
    Equal to ``jnp.sum`` bit for bit at every SE and LCNet shape of the rec
    (tools/cpu_parity_probe.py dw).  ``scale``: the terms are ``x * scale``,
    a multiply that XLA's fusion contracts into the window sums' adds
    (:func:`_sum_in_order`)."""
    h, w = x.shape[-2:]
    if h <= window and w <= window:
        return _sum_in_order(x.float().flatten(-2), scale)
    cuts = []
    for n in (h, w):
        padded = -(-n // window) * window if n > window else n
        cuts.append((min(n, window), padded, (padded - n) // 2))
    (wh, ph, lh), (ww, pw, lw) = cuts
    x = F.pad(x.float(), (lw, pw - w - lw, lh, ph - h - lh))
    x = x.unflatten(-1, (pw // ww, ww)).unflatten(-3, (ph // wh, wh))
    return xla_hw_sum(_sum_in_order(x.movedim(-3, -2).flatten(-2), scale), window=window)


def _xla_dot_order(m: int, k: int, n: int) -> tuple[str, int]:
    """The order in which XLA:CPU's float32 dot [M, K] x [K, N] sums its K
    products, as read against ``jax.jit(jnp.dot)`` at the SE gates' shapes
    (Eigen's blocking, which depends on the shape;
    tools/cpu_parity_probe.py dw): ``("lanes", L)``, L interleaved partial
    sums (term i into sum i mod L) added pairwise; or ``("blocks", B)``,
    blocks of B terms each summed from zero, the block sums added in order
    (B = K: one sequential sum).  Shapes not read take the sequential sum."""
    if m >= 2:
        if (k, n) == (64, 16):
            return "lanes", 4
        if (k, n) == (512, 128) and m <= 32:
            return "blocks", 256
        if (k, n) == (128, 512) and m <= 50:
            return "blocks", 64
        if (k, n) == (128, 32) and m >= 51:
            return "lanes", 2
    return "blocks", k


def xla_dot(a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """float32 [M, K] x [K, N] summed in :func:`_xla_dot_order`'s order.
    Products of compute-dtype values are exact in float32, so the order
    alone decides the bits."""
    a, w = a.float(), w.float()
    m, k = a.shape
    kind, size = _xla_dot_order(m, k, w.shape[1])
    terms = a[:, :, None] * w[None]  # [M, K, N]
    if kind == "lanes":
        parts = [_sum_in_order(terms[:, i::size].transpose(1, 2)) for i in range(size)]
        while len(parts) > 1:
            parts = [parts[i] + parts[i + 1] for i in range(0, len(parts), 2)]
        return parts[0]
    out = None
    for b in range(0, k, size):
        blk = _sum_in_order(terms[:, b:b + size].transpose(1, 2))
        out = blk if out is None else out + blk
    return out


ACTIVATIONS: dict[str, Callable[[torch.Tensor], torch.Tensor]] = {
    "relu": F.relu,
    "relu6": lambda x: torch.clamp(x, 0.0, 6.0),
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


_THREAD = threading.local()


@contextlib.contextmanager
def full_float32() -> Iterator[None]:
    """Within, on this thread, the convs that feed a BatchNorm run in full
    float32 on CUDA: :func:`_tf32_convs` leaves cuDNN's TF32 flag as it
    finds it (off, as the engines set it).  The staged engine runs its
    forwards so (``pipeline.engine.TorchEngine``)."""
    prev = getattr(_THREAD, "no_tf32", False)
    _THREAD.no_tf32 = True
    try:
        yield
    finally:
        _THREAD.no_tf32 = prev


@contextlib.contextmanager
def _tf32_convs(x: torch.Tensor) -> Iterator[None]:
    """On a CUDA tensor, lets cuDNN run the float32 convs inside in TF32 and
    restores the caller's setting after; elsewhere changes nothing.  Only
    for operands that hold bf16 values: TF32's 10-bit mantissa carries
    bf16's 7 bits exactly and each product fits in float32, so TF32
    computes a float32 conv of the same values at the tensor cores' rate;
    only the order and rounding of its sums differ from full float32.  The
    switch is cuDNN's process-wide flag, held for the one conv, so two
    threads must not run model code at once: a session's staged engine and
    its fused pipeline both call the models only under the session's one
    dispatch lock (``TorchEngine.lock``, ``DevicePipeline._lock``).  One
    flag, not ``torch.backends.cudnn.flags``, which sets and restores every
    cuDNN flag around each conv on a host-bound pipeline."""
    if not x.is_cuda or getattr(_THREAD, "no_tf32", False):
        yield
        return
    cudnn = torch.backends.cudnn
    prev = cudnn.allow_tf32
    cudnn.allow_tf32 = True
    try:
        yield
    finally:
        cudnn.allow_tf32 = prev


# Eigen caps the contraction block of a multi-threaded float32 product at
# 320 (``computeProductBlockingSizes``), and the contraction evens the
# blocks out, rounded up to 8: 1,152, 1,728 and 2,304 -> blocks of 288,
# 3,456 -> 320 (measured against XLA:CPU, tools/cpu_parity_probe.py det)
_XLA_KC_CAP = 320


def _xla_kc(k: int) -> int:
    even = -(-k // -(-k // _XLA_KC_CAP))
    return -(-even // 8) * 8


def _conv_f32_cpu(x: torch.Tensor, w: torch.Tensor, stride: tuple[int, int],
                  pads: tuple[int, int, int, int], as_dot: bool = False
                  ) -> torch.Tensor | None:
    """float32 conv of NCHW ``x`` summed in XLA:CPU's order (the native
    ``conv_xla``: Eigen's blocked fused multiply-add chains over (kh, kw,
    cin)), or None without the native library.  ``pads``: (top, bottom,
    left, right).  ``as_dot``: XLA runs this 1 x 1 conv as an HLO ``dot``,
    which sums its K products in one sequential chain at the rec's
    pointwise shapes (tools/cpu_parity_probe.py dw), not in blocks."""
    from ..native import conv_xla_native

    n, cin, h, wd = x.shape
    cout, _, kh, kw = w.shape
    oh = (h + pads[0] + pads[1] - kh) // stride[0] + 1
    ow = (wd + pads[2] + pads[3] - kw) // stride[1] + 1
    out = conv_xla_native(x.detach().permute(0, 2, 3, 1).numpy(),
                          w.detach().permute(2, 3, 1, 0).numpy(),
                          stride, (pads[0], pads[2]), (oh, ow),
                          kh * kw * cin if as_dot else _xla_kc(kh * kw * cin),
                          torch.get_num_threads())
    return None if out is None else torch.from_numpy(out).permute(0, 3, 1, 2)


# XLA:CPU runs a depthwise conv (HLO ``convolution`` with
# ``feature_group_count == C``) as one Eigen contraction per channel of its
# (kh, kw) taps, and sums the taps' products in this fixed tree at every
# shape measured: read by cancelling pairs of taps (a huge weight and its
# negative, every other tap 1) and confirmed on random bf16 data
# (tools/cpu_parity_probe.py dw).  Leaves index taps in (kh, kw) order.
_DW_TREES = {
    9: ((((0, 1), (4, 5)), ((2, 3), (6, 7))), 8),
    25: (((((((0, 8), (1, 9)), ((4, 12), (5, 13))),
            (((2, 10), (3, 11)), ((6, 14), (7, 15)))),
           (((16, 17), (20, 21)), ((18, 19), (22, 23))))), 24),
}


def _tree_sum(terms: list[torch.Tensor], node) -> torch.Tensor:
    if isinstance(node, int):
        return terms[node]
    return _tree_sum(terms, node[0]) + _tree_sum(terms, node[1])


def _depthwise_f32_cpu(x: torch.Tensor, w: torch.Tensor, stride: tuple[int, int],
                       pads: tuple[int, int, int, int]) -> torch.Tensor | None:
    """float32 depthwise conv of NCHW ``x`` ([C, 1, kh, kw] weights) summed
    in XLA:CPU's tree (:data:`_DW_TREES`), or None for a kernel size
    without one.  The products of compute-dtype values are exact in
    float32, so only the tree decides the bits."""
    kh, kw = w.shape[2:]
    tree = _DW_TREES.get(kh * kw)
    if tree is None:
        return None
    x = F.pad(x, (pads[2], pads[3], pads[0], pads[1]))
    oh = (x.shape[2] - kh) // stride[0] + 1
    ow = (x.shape[3] - kw) // stride[1] + 1
    terms = [x[:, :, i:i + stride[0] * (oh - 1) + 1:stride[0],
               j:j + stride[1] * (ow - 1) + 1:stride[1]] * w[:, 0, i, j][:, None, None]
             for i in range(kh) for j in range(kw)]
    return _tree_sum(terms, tree)


def _compute_params(m: nn.Module) -> tuple[torch.Tensor, torch.Tensor | None]:
    """``m``'s weight and bias in its compute dtype: cast at the call from
    float32 master weights (differentiable), unchanged once
    :func:`cast_compute` has cast them."""
    dt = m.compute_dtype or m.weight.dtype
    b = None if m.bias is None else m.bias.to(dt)
    return m.weight.to(dt), b


class Conv(nn.Conv2d):
    """``nn.Conv(padding="SAME")`` in NCHW: input and parameters are cast to
    the compute dtype (``compute_dtype``, else the parameter dtype).  With
    ``f32_out`` the conv runs in float32 on those cast values and returns
    float32 (no rounding of the result to the compute dtype)."""

    compute_dtype: torch.dtype | None = None
    xla_dot = False  # XLA compiles this 1 x 1 conv to a dot (_conv_f32_cpu)

    def __init__(self, in_ch: int, out_ch: int, kernel=1, stride=1, groups: int = 1,
                 bias: bool = True):
        super().__init__(in_ch, out_ch, _pair(kernel), _pair(stride), padding=0,
                         groups=groups, bias=bias)
        self.training = False

    def forward(self, x: torch.Tensor, f32_out: bool = False) -> torch.Tensor:
        (kh, kw), (sh, sw) = self.kernel_size, self.stride
        ph = _same_pads(x.shape[2], kh, sh)
        pw = _same_pads(x.shape[3], kw, sw)
        w, b = _compute_params(self)
        x = x.to(w.dtype)
        # in inference on the CPU a bf16 conv sums in XLA:CPU's order, dense
        # or depthwise; a conv over a 1 x 1 map with a bias (the SE gate) is
        # left to oneDNN, as the rewrite into XLA's order did not match XLA
        # there
        if w.dtype != torch.float32 and not x.is_cuda and not self.training and (
                b is None or x.shape[2] * x.shape[3] > 1):
            y = None
            if self.groups == 1:
                y = _conv_f32_cpu(x.float(), w.float(), self.stride, (*ph, *pw),
                                  self.xla_dot)
            elif self.groups == self.in_channels == self.out_channels:
                y = _depthwise_f32_cpu(x.float(), w.float(), self.stride, (*ph, *pw))
            if y is not None:
                if f32_out:
                    return y
                y = y.to(w.dtype)
                return y if b is None else y + b[:, None, None]
        if ph[0] == ph[1] and pw[0] == pw[1]:
            pad = (ph[0], pw[0])
        else:
            x, pad = F.pad(x, (pw[0], pw[1], ph[0], ph[1])), 0
        if not f32_out or w.dtype == torch.float32:
            return F.conv2d(x, w, b, self.stride, pad, groups=self.groups)
        x, w = x.float(), w.float()
        b = None if b is None else b.float()
        with _tf32_convs(x):
            return F.conv2d(x, w, b, self.stride, pad, groups=self.groups)


class Dense(nn.Linear):
    """``nn.Dense``: input cast to the compute dtype; the product rounds to
    that dtype before the bias add, which rounds again (two ops in Flax, not
    a fused bias).  With ``f32_out`` the bias add's float32 sum is returned
    unrounded."""

    compute_dtype: torch.dtype | None = None

    def forward(self, x: torch.Tensor, f32_out: bool = False) -> torch.Tensor:
        w, b = _compute_params(self)
        y = F.linear(x.to(w.dtype), w)
        if f32_out:
            return y.float() + b.float()
        return y + b


class BatchNorm(nn.Module):
    """BatchNorm with Flax's arithmetic (flax ``_normalize``): ``(x - mean) *
    (rsqrt(var + eps) * scale) + bias`` in float32, cast back to the input
    dtype.  momentum 0.9, eps 1e-5 (common.py:81-83).

    Inference normalises by the running statistics; on the CPU it takes
    XLA:CPU's steps (``native`` ``rsqrt_xla``, the multiply and the add
    fused), on CUDA ``torch.rsqrt`` and two roundings.  Training normalises
    by the batch's float32 statistics over (N, H, W) in flax's fast-variance
    form, ``var = max(0, E[x^2] - E[x]^2)`` (``_compute_stats``), and
    updates ``ra = momentum * ra + (1 - momentum) * batch`` with that biased
    variance (``F.batch_norm`` would update with the unbiased one)."""

    def __init__(self, ch: int, eps: float = 1e-5, momentum: float = 0.9):
        super().__init__()
        self.eps = eps
        self.momentum = momentum
        self.training = False
        self.weight = nn.Parameter(torch.ones(ch))
        self.bias = nn.Parameter(torch.zeros(ch))
        self.register_buffer("running_mean", torch.zeros(ch))
        self.register_buffer("running_var", torch.ones(ch))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.training:
            x32 = x.float()
            mean = x32.mean(dim=(0, 2, 3))
            var = torch.clamp((x32 * x32).mean(dim=(0, 2, 3)) - mean * mean, min=0.0)
            with torch.no_grad():
                m = self.momentum
                self.running_mean.mul_(m).add_((1.0 - m) * mean.detach())
                self.running_var.mul_(m).add_((1.0 - m) * var.detach())
            mul = torch.rsqrt(var + self.eps) * self.weight.float()
            y = (x32 - mean[:, None, None]) * mul[:, None, None] + self.bias.float()[:, None, None]
            return y.to(x.dtype)
        var = self.running_var.float() + self.eps
        d = x.float() - self.running_mean.float()[:, None, None]
        if not x.is_cuda:
            from ..native import rsqrt_xla_native

            r = rsqrt_xla_native(var.detach().numpy())
            if r is not None:
                # XLA:CPU's fusion: its rsqrt, then one fused multiply-add
                mul = torch.from_numpy(r) * self.weight.float()
                y = d.double() * mul.double()[:, None, None] + self.bias.double()[:, None, None]
                return y.float().to(x.dtype)
        mul = torch.rsqrt(var) * self.weight.float()
        return (d * mul[:, None, None] + self.bias.float()[:, None, None]).to(x.dtype)


class LayerNorm(nn.Module):
    """Flax ``nn.LayerNorm`` over the last axis: eps **1e-6** (svtr.py:95),
    statistics and affine in float32.  Returns float32: the caller rounds to
    its compute dtype (XLA hands a LayerNorm the unrounded float32 sum of
    the bias or residual add before it, see ``models.svtr``)."""

    def __init__(self, dim: int, eps: float = 1e-6):
        super().__init__()
        self.eps = eps
        self.training = False
        self.weight = nn.Parameter(torch.ones(dim))
        self.bias = nn.Parameter(torch.zeros(dim))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.layer_norm(x.float(), (x.shape[-1],), self.weight.float(),
                            self.bias.float(), self.eps)


class ConvBNAct(nn.Module):
    """Conv (no bias) + BatchNorm + activation (common.py:59-84).  The conv's
    output stays float32 into the BatchNorm, which rounds to the compute
    dtype once, as XLA compiles the Flax module."""

    def __init__(self, in_ch: int, out_ch: int, kernel=3, stride=1, groups: int = 1,
                 act: str = "hardswish"):
        super().__init__()
        self.Conv_0 = Conv(in_ch, out_ch, kernel, stride, groups, bias=False)
        self.BatchNorm_0 = BatchNorm(out_ch)
        self.act = act

    def forward(self, x: torch.Tensor, keep_f32: bool = False):
        """With ``keep_f32`` (hard-swish only) returns the activation and,
        beside it, ``bf16(y * clip(y + 3, 0, 6))`` as float32, the product
        before its multiply by float32(1/6) (:data:`HARD_SWISH_SCALE`): a
        mean that follows the block (an SE gate, the LCNet's final mean over
        the height) reads the unrounded ``product * (1/6)`` in XLA, with the
        multiply fused into its sum (:func:`xla_hw_sum`)."""
        conv = self.Conv_0
        y = self.BatchNorm_0(conv(x, f32_out=True))
        y = y.to(conv.compute_dtype or conv.weight.dtype)
        if keep_f32:
            p = (y * torch.clamp(y + 3.0, 0.0, 6.0)).float()
            return (p * HARD_SWISH_SCALE).to(y.dtype), p
        return ACTIVATIONS[self.act](y)


class SEModule(nn.Module):
    """Squeeze-and-excitation with the Paddle hard-sigmoid gate
    (common.py:87-100)."""

    def __init__(self, ch: int, reduction: int = 4):
        super().__init__()
        self.Conv_0 = Conv(ch, max(ch // reduction, 1), 1)
        self.Conv_1 = Conv(max(ch // reduction, 1), ch, 1)

    def forward(self, x: torch.Tensor, x32: torch.Tensor | None = None) -> torch.Tensor:
        """``x32``: the hard-swish product ``x`` was rounded from, before its
        1/6, which XLA's mean reads (``ConvBNAct(keep_f32=True)``).  On the CPU in inference
        the mean and both 1 x 1 convs take XLA:CPU's order
        (:func:`xla_hw_sum`, :func:`xla_dot`), each conv's product rounding
        to the compute dtype before its bias add, as the HLO ``dot`` and
        ``add`` do; elsewhere the mean reads ``x`` and the convs are
        ``F.conv2d``."""
        if x.is_cuda or self.training:
            s = mean_f32(x, (2, 3)).to(x.dtype)
            s = self.Conv_1(F.relu(self.Conv_0(s)))
            return x * hard_sigmoid(s)
        total = xla_hw_sum(x) if x32 is None else xla_hw_sum(x32, HARD_SWISH_SCALE)
        s = (total * (1.0 / (x.shape[2] * x.shape[3]))).to(x.dtype)
        for i, conv in enumerate((self.Conv_0, self.Conv_1)):
            w, b = _compute_params(conv)
            s = xla_dot(s, w[:, :, 0, 0].t()).to(w.dtype) + b
            if i == 0:
                s = F.relu(s)
        return x * hard_sigmoid(s[:, :, None, None])


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


def _cast_sites(module: nn.Module) -> Iterator[nn.Module]:
    """Every Conv, Dense and attention projection under ``module``."""
    for m in module.modules():
        if isinstance(m, (Conv, Dense)) or getattr(m, "compute_cast", False):
            yield m


def set_compute_dtype(module: nn.Module, dtype: torch.dtype | None) -> nn.Module:
    """Make every Conv, Dense and attention projection under ``module``
    compute in ``dtype`` (None: float32) from float32 parameters, casting
    its weight at each call (the model classes call this on themselves)."""
    for m in _cast_sites(module):
        m.compute_dtype = dtype
    return module


def cast_compute(module: nn.Module, dtype: torch.dtype | None) -> nn.Module:
    """Cast the parameters of every Conv, Dense and attention projection to
    the compute dtype, for inference (Flax casts them per call; casting
    once is the same arithmetic).  BatchNorm and LayerNorm keep float32
    parameters.  A cast model refuses ``train()``: it would train bf16
    weights (``ComputeModel.train``)."""
    if dtype is None or dtype == torch.float32:
        return module
    for m in _cast_sites(module):
        for p in m.parameters(recurse=False):
            p.data = p.data.to(dtype)
    return module


class ComputeModel(nn.Module):
    """Base of the model classes: float32 parameters computing in ``dtype``
    (None: float32).  A subclass builds its layers, then calls
    :meth:`finish_init`, which hands ``dtype`` to every Conv, Dense and
    attention projection and leaves the model in inference mode."""

    def __init__(self, dtype: torch.dtype | None = None):
        super().__init__()
        self.compute_dtype = dtype

    def finish_init(self) -> None:
        set_compute_dtype(self, self.compute_dtype)
        self.train(False)

    def train(self, mode: bool = True) -> "ComputeModel":
        """Training keeps float32 master weights: a model whose parameters
        :func:`cast_compute` has cast raises."""
        if mode and any(p.dtype != torch.float32 for m in _cast_sites(self)
                        for p in m.parameters(recurse=False)):
            raise RuntimeError(
                f"{type(self).__name__} was cast to its compute dtype for inference "
                "(cast_compute) and cannot train: build it again with float32 parameters")
        return super().train(mode)
