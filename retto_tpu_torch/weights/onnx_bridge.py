"""ONNX graph -> PyTorch function.

The port's counterpart of ``retto_tpu/weights/onnx_bridge.py`` (the JAX
translator that replaces the reference's ONNX Runtime sessions,
ort_worker.rs:120-135, 188-221): the graph is translated op by op into
torch calls, so the reference's PP-OCRv4 ``.onnx`` artifacts run on the
card through the same ``det/cls/rec`` engine contract.  The registry holds
the same 63 op handlers, and the executor is the same two-level one:
values whose every ancestor is an initializer or a static shape stay NumPy
and fold on the host (Paddle's Shape -> Gather -> Concat -> Reshape
chains), so every shape is a Python int.

The translator reproduces the JAX bridge's results, including where that
bridge departs from the ONNX spec (ROADMAP Queue 3 lists them): ``Resize``
is ``jax.image.resize`` (half-pixel ``nearest``, an antialiased ``linear``
on a downscale, ``coordinate_transformation_mode`` and ``nearest_mode``
ignored); ``Gather`` wraps a negative index once and fills an index out of
range (NaN for floats); ``Conv``'s ``SAME_LOWER`` pads as ``SAME_UPPER``;
``ConvTranspose`` takes only ``group == 1`` and ignores
``output_padding``, ``dilations`` and ``output_shape``; ``MaxPool`` and
``AveragePool`` ignore ``ceil_mode``, ``dilations`` and ``auto_pad``;
``LayerNormalization`` normalises over ``axis`` alone; ``Softmax`` is
per axis at every opset; ``ArgMax`` ignores ``select_last_index``.
Integer tensors keep torch's int64 where JAX (x64 off) holds int32: the
values agree.

Everything computes in float32.  Nothing uploads inside a call that a
CUDA graph captures: the initializers are device tensors (the caller's
``params``), :meth:`OnnxFunction.prepare` puts every input-independent
folded value (a ``Constant``, a ``Clip`` bound) on the device at build
time, and a folded value that depends on an input's shape is put there
at the first call with that shape, which ``pipeline.graphs`` makes
before it captures.  Index vectors (``Resize``, ``Slice`` with a
negative step, ``Pad``'s edge and reflect modes) come from
``torch.arange`` on the device.
"""

from __future__ import annotations

import math
from pathlib import Path
from typing import Any, Callable

import numpy as np
import torch
import torch.nn.functional as F

from ..errors import RettoWeightsError
from .onnx_proto import OnnxModel, parse_model, tensor_to_numpy

__all__ = ["OnnxFunction", "load_onnx", "build_fn"]


def _static(v: Any) -> bool:
    return isinstance(v, (np.ndarray, np.generic, int, float, bool))


def _np(v: Any) -> np.ndarray:
    if _static(v):
        return np.asarray(v)
    raise RettoWeightsError(
        "onnx bridge: a dynamic tensor feeds a shape-like input; this graph "
        "needs data-dependent shapes, which the translator does not support"
    )


def _ints(v: Any) -> list[int]:
    return [int(x) for x in np.atleast_1d(_np(v))]


_DT = {  # ONNX TensorProto.DataType -> (numpy, torch)
    1: (np.float32, torch.float32), 6: (np.int32, torch.int32),
    7: (np.int64, torch.int64), 9: (np.bool_, torch.bool),
    10: (np.float16, torch.float16), 11: (np.float64, torch.float64),
    2: (np.uint8, torch.uint8), 3: (np.int8, torch.int8),
}


def _device_value(v: Any, device: torch.device) -> torch.Tensor:
    """A host value as a device tensor; float64 becomes float32, as in JAX
    with x64 off."""
    a = np.ascontiguousarray(v)
    if a.dtype == np.float64:
        a = a.astype(np.float32)
    if not a.flags.writeable:  # a folded broadcast view
        a = a.copy()
    return torch.as_tensor(a, device=device)


def _pool_padding(attrs, spatial: int) -> list[tuple[int, int]]:
    pads = attrs.get("pads", [0] * 2 * spatial)
    return [(pads[i], pads[i + spatial]) for i in range(spatial)]


def _torch_pads(cfg: list[tuple[int, int]]) -> list[int]:
    """[(lo, hi)] per axis, first axis first -> ``F.pad``'s flat list, last
    axis first."""
    out: list[int] = []
    for lo, hi in reversed(cfg):
        out += [lo, hi]
    return out


class _Ops:
    """Op registry: each handler takes (attrs, *inputs) -> output(s)."""

    registry: dict[str, Callable] = {}

    @classmethod
    def register(cls, *names):
        def deco(fn):
            for n in names:
                cls.registry[n] = fn
            return fn

        return deco


op = _Ops.register


# ----------------------------- elementwise ---------------------------- #
@op("Add")
def _add(a, x, y):
    return x + y


@op("Sub")
def _sub(a, x, y):
    return x - y


@op("Mul")
def _mul(a, x, y):
    return x * y


def _is_int(v) -> bool:
    if isinstance(v, torch.Tensor):
        return not (v.is_floating_point() or v.is_complex() or v.dtype == torch.bool)
    return bool(np.issubdtype(np.asarray(v).dtype, np.integer))


@op("Div")
def _div(a, x, y):
    # ONNX Div on integer tensors is C-style integer division (truncation
    # toward zero): torch exports chunk/split sizing as Shape -> Add -> Div
    # -> Mul chains feeding Slice bounds
    if _is_int(x) and _is_int(y):
        if _static(x) and _static(y):
            q = np.abs(x) // np.abs(y)
            return np.where((np.asarray(x) < 0) != (np.asarray(y) < 0), -q, q)
        return torch.div(x, y, rounding_mode="trunc")
    return x / y


@op("Pow")
def _pow(a, x, y):
    return x**y


@op("Neg")
def _neg(a, x):
    return -x


@op("Sqrt")
def _sqrt(a, x):
    return torch.sqrt(x)


@op("Exp")
def _exp(a, x):
    return torch.exp(x)


@op("Log")
def _log(a, x):
    return torch.log(x)


@op("Erf")
def _erf(a, x):
    return torch.erf(x)


@op("Tanh")
def _tanh(a, x):
    return torch.tanh(x)


@op("Relu")
def _relu(a, x):
    return torch.clamp(x, min=0)


@op("LeakyRelu")
def _leaky(a, x):
    return torch.where(x >= 0, x, x * a.get("alpha", 0.01))


@op("Sigmoid")
def _sigmoid(a, x):
    return torch.sigmoid(x)


@op("HardSigmoid")
def _hardsigmoid(a, x):
    return torch.clamp(x * a.get("alpha", 0.2) + a.get("beta", 0.5), 0.0, 1.0)


@op("HardSwish")
def _hardswish(a, x):
    return x * torch.clamp(x / 6.0 + 0.5, 0.0, 1.0)


@op("Clip")
def _clip(a, x, lo=None, hi=None):
    lo = a.get("min", lo)
    hi = a.get("max", hi)
    # bounds take x's dtype (jnp.asarray(lo, x.dtype) in the JAX bridge)
    if lo is not None:
        x = (torch.clamp(x, min=float(lo)) if _static(lo)
             else torch.maximum(x, lo.to(x.dtype)))
    if hi is not None:
        x = (torch.clamp(x, max=float(hi)) if _static(hi)
             else torch.minimum(x, hi.to(x.dtype)))
    return x


@op("Where")
def _where(a, c, x, y):
    return torch.where(c.to(torch.bool), x, y)


@op("Equal")
def _equal(a, x, y):
    return x == y


@op("Greater")
def _greater(a, x, y):
    return x > y


@op("Less")
def _less(a, x, y):
    return x < y


@op("Not")
def _not(a, x):
    return torch.logical_not(x)


@op("Abs")
def _abs(a, x):
    return torch.abs(x)


@op("Floor")
def _floor(a, x):
    return np.floor(x) if _static(x) else torch.floor(x)


@op("Ceil")
def _ceil(a, x):
    return np.ceil(x) if _static(x) else torch.ceil(x)


@op("Round")
def _round(a, x):
    # half to even, as np.rint and jnp.rint
    return np.rint(x) if _static(x) else torch.round(x)


@op("Min")
def _min(a, *xs):
    out = xs[0]
    for x in xs[1:]:
        out = np.minimum(out, x) if _static(out) and _static(x) else torch.minimum(out, x)
    return out


@op("Max")
def _max(a, *xs):
    out = xs[0]
    for x in xs[1:]:
        out = np.maximum(out, x) if _static(out) and _static(x) else torch.maximum(out, x)
    return out


@op("Tile")
def _tile(a, x, reps):
    return x.repeat(*_ints(reps))


@op("Softmax")
def _softmax(a, x):
    return torch.softmax(x, dim=a.get("axis", -1))


@op("Identity", "Dropout")
def _identity(a, x, *rest):
    return x


@op("Cast")
def _cast(a, x):
    to_np, to_t = _DT.get(a["to"], (np.float32, torch.float32))
    if _static(x):
        return np.asarray(x).astype(to_np)
    return x.to(to_t)


# ------------------------------ structure ----------------------------- #
@op("Shape")
def _shape(a, x):
    return np.asarray(tuple(x.shape), np.int64)


@op("Constant")
def _constant(a):
    if "value" in a:
        return tensor_to_numpy(a["value"])
    for k in ("value_float", "value_int"):
        if k in a:
            return np.asarray(a[k])
    if "value_floats" in a:
        return np.asarray(a["value_floats"], np.float32)
    if "value_ints" in a:
        return np.asarray(a["value_ints"], np.int64)
    raise RettoWeightsError("Constant node without value")


@op("ConstantOfShape")
def _constant_of_shape(a, shape):
    fill = tensor_to_numpy(a["value"]).reshape(-1)[0] if "value" in a else np.float32(0)
    return np.full(_ints(shape), fill)


@op("Reshape")
def _reshape(a, x, shape):
    tgt = _ints(shape)
    xs = list(x.shape)
    # onnx: 0 copies the input dim (unless allowzero), -1 infers
    out = [
        xs[i] if (d == 0 and not a.get("allowzero", 0)) else d
        for i, d in enumerate(tgt)
    ]
    if -1 in out:
        fixed = int(np.prod([d for d in out if d != -1]))
        out[out.index(-1)] = int(np.prod(xs)) // max(fixed, 1)
    return np.reshape(x, out) if _static(x) else x.reshape(out)


@op("Transpose")
def _transpose(a, x):
    perm = a.get("perm")
    if _static(x):
        return np.transpose(x, perm)
    return x.permute(*(perm if perm is not None else reversed(range(x.dim()))))


@op("Concat")
def _concat(a, *xs):
    axis = a["axis"]
    if all(_static(x) for x in xs):
        return np.concatenate([np.atleast_1d(_np(x)) for x in xs], axis=axis)
    return torch.cat(xs, dim=axis)


@op("Split")
def _split(a, x, split=None):
    axis = a.get("axis", 0)
    sizes = a.get("split") or (None if split is None else _ints(split))
    if sizes is None:
        num = a.get("num_outputs")
        sizes = [x.shape[axis] // num] * num
    # jnp.split at the running sums: the last part takes the rest
    return tuple(torch.tensor_split(x, [int(i) for i in np.cumsum(sizes)[:-1]], dim=axis))


@op("Slice")
def _slice(a, x, starts=None, ends=None, axes=None, steps=None):
    if starts is None:  # opset < 10: attributes
        starts, ends = a["starts"], a["ends"]
        axes = a.get("axes")
        steps = None
    starts, ends = _ints(starts), _ints(ends)
    axes = list(range(len(starts))) if axes is None else _ints(axes)
    steps = [1] * len(starts) if steps is None else _ints(steps)
    int32_max = np.iinfo(np.int32).max
    if _static(x):
        sl = [slice(None)] * np.ndim(x)
        for s, e, ax, st in zip(starts, ends, axes, steps):
            sl[ax] = slice(s, None if e >= int32_max else e, st)
        return np.asarray(x)[tuple(sl)]
    for s, e, ax, st in zip(starts, ends, axes, steps):
        ax = ax % x.dim()
        lo, hi, st = slice(s, None if e >= int32_max else e, st).indices(x.shape[ax])
        if st > 0:
            idx = [slice(None)] * x.dim()
            idx[ax] = slice(lo, max(hi, lo), st)
            x = x[tuple(idx)]
        else:  # torch slices take no negative step
            x = x.index_select(ax, torch.arange(lo, hi, st, device=x.device))
    return x


@op("Squeeze")
def _squeeze(a, x, axes=None):
    ax = a.get("axes") or (None if axes is None else _ints(axes))
    if _static(x):
        return np.squeeze(x) if ax is None else np.squeeze(x, axis=tuple(int(i) for i in ax))
    if ax is None:
        return torch.squeeze(x)
    return torch.squeeze(x, dim=tuple(int(i) for i in ax))


@op("Unsqueeze")
def _unsqueeze(a, x, axes=None):
    ax = a.get("axes") or _ints(axes)
    for i in sorted(int(v) for v in ax):
        x = np.expand_dims(x, i) if _static(x) else x.unsqueeze(i)
    return x


def _take(x: torch.Tensor, idx: torch.Tensor, axis: int) -> torch.Tensor:
    """``jnp.take(x, idx, axis)``: a negative index wraps once, an index out
    of range reads the fill value (NaN for floats, the dtype's minimum for
    signed ints, its maximum for unsigned)."""
    axis = axis % x.dim()
    n = x.shape[axis]
    idx = idx.to(torch.int64)
    idx = torch.where(idx < 0, idx + n, idx)
    bad = (idx < 0) | (idx >= n)
    flat = x.index_select(axis, torch.clamp(idx, 0, max(n - 1, 0)).reshape(-1))
    out = flat.reshape(*x.shape[:axis], *idx.shape, *x.shape[axis + 1:])
    if x.is_floating_point():
        fill = float("nan")
    elif x.dtype == torch.bool:
        fill = True
    elif x.dtype == torch.uint8:
        fill = torch.iinfo(x.dtype).max
    else:
        fill = torch.iinfo(x.dtype).min
    shape = (1,) * axis + tuple(idx.shape) + (1,) * (x.dim() - axis - 1)
    return torch.where(bad.reshape(shape), torch.full((), fill, dtype=x.dtype,
                                                      device=x.device), out)


@op("Gather")
def _gather(a, x, idx):
    axis = a.get("axis", 0)
    if _static(x) and _static(idx):
        return np.take(np.asarray(x), np.asarray(idx).astype(np.int64), axis=axis)
    return _take(x, idx, axis)


@op("Expand")
def _expand(a, x, shape):
    tgt = _ints(shape)
    # onnx Expand uses numpy broadcasting vs target
    out_shape = np.broadcast_shapes(tuple(x.shape), tuple(tgt))
    if _static(x):
        return np.broadcast_to(x, out_shape)
    return x.expand(*out_shape)


@op("Range")
def _range(a, start, limit, delta):
    return np.arange(int(_np(start)), int(_np(limit)), int(_np(delta)))


@op("Flatten")
def _flatten(a, x):
    axis = a.get("axis", 1)
    lead = int(np.prod(x.shape[:axis])) if axis else 1
    return x.reshape(lead, -1)


def _edge_or_reflect(x: torch.Tensor, cfg: list[tuple[int, int]], mode: str) -> torch.Tensor:
    """``jnp.pad``'s ``edge`` and ``reflect`` modes on every axis, by index
    vectors made on the device."""
    for ax, (lo, hi) in enumerate(cfg):
        if not lo and not hi:
            continue
        n = x.shape[ax]
        i = torch.arange(-lo, n + hi, device=x.device)
        if mode == "edge":
            i = torch.clamp(i, 0, n - 1)
        else:  # reflect about the edge samples, period 2(n - 1)
            p = max(2 * (n - 1), 1)
            i = torch.remainder(i, p)
            i = torch.where(i >= n, p - i, i)
        x = x.index_select(ax, i)
    return x


@op("Pad")
def _pad(a, x, pads=None, value=None):
    mode = a.get("mode", "constant")
    p = a.get("pads") or _ints(pads)
    n = x.dim()
    cfg = [(p[i], p[i + n]) for i in range(n)]
    cv = float(_np(value)) if value is not None else 0.0
    if mode == "constant":
        return F.pad(x, _torch_pads(cfg), value=cv)
    return _edge_or_reflect(x, cfg, {"reflect": "reflect", "edge": "edge"}[mode])


# ----------------------------- reductions ----------------------------- #
def _reduce(fn, a, x, axes_in=None):
    ax = a.get("axes") or (None if axes_in is None else _ints(axes_in))
    keep = bool(a.get("keepdims", 1))
    dims = tuple(range(x.dim())) if ax is None else tuple(int(i) for i in ax)
    return fn(x, dim=dims, keepdim=keep)


@op("ReduceMean")
def _reduce_mean(a, x, axes=None):
    return _reduce(torch.mean, a, x, axes)


@op("ReduceSum")
def _reduce_sum(a, x, axes=None):
    return _reduce(torch.sum, a, x, axes)


@op("ReduceMax")
def _reduce_max(a, x, axes=None):
    return _reduce(torch.amax, a, x, axes)


@op("ReduceMin")
def _reduce_min(a, x, axes=None):
    return _reduce(torch.amin, a, x, axes)


@op("ArgMax")
def _argmax(a, x):
    return torch.argmax(x, dim=a.get("axis", 0), keepdim=bool(a.get("keepdims", 1)))


# ------------------------------- linear ------------------------------- #
@op("MatMul")
def _matmul(a, x, y):
    return torch.matmul(x, y)


@op("Gemm")
def _gemm(a, x, w, b=None):
    alpha, beta = a.get("alpha", 1.0), a.get("beta", 1.0)
    if a.get("transA"):
        x = x.T
    if a.get("transB"):
        w = w.T
    out = alpha * (x @ w)
    if b is not None:
        out = out + beta * b
    return out


@op("LayerNormalization")
def _layernorm(a, x, scale, bias=None):
    axis = a.get("axis", -1)
    eps = a.get("epsilon", 1e-5)
    mean = torch.mean(x, dim=axis, keepdim=True)
    var = torch.mean(torch.square(x - mean), dim=axis, keepdim=True)
    out = (x - mean) / torch.sqrt(var + eps) * scale
    if bias is not None:
        out = out + bias
    return out


# ----------------------------- conv / pool ---------------------------- #
_CONV = {1: F.conv1d, 2: F.conv2d, 3: F.conv3d}


@op("Conv")
def _conv(a, x, w, b=None):
    spatial = x.dim() - 2
    strides = a.get("strides", [1] * spatial)
    dil = a.get("dilations", [1] * spatial)
    group = a.get("group", 1)
    auto = a.get("auto_pad", "NOTSET")
    if auto in ("SAME_UPPER", "SAME_LOWER"):
        # lax "SAME" for both: the odd pixel of padding goes after
        cfg = []
        for i in range(spatial):
            size, k = x.shape[2 + i], (w.shape[2 + i] - 1) * dil[i] + 1
            total = max((-(-size // strides[i]) - 1) * strides[i] + k - size, 0)
            cfg.append((total // 2, total - total // 2))
    elif auto == "VALID":
        cfg = [(0, 0)] * spatial
    else:
        pads = a.get("pads", [0] * 2 * spatial)
        cfg = [(pads[i], pads[i + spatial]) for i in range(spatial)]
    if all(lo == hi for lo, hi in cfg):
        padding = [lo for lo, _ in cfg]
    else:
        x, padding = F.pad(x, _torch_pads(cfg)), 0
    return _CONV[spatial](x, w, b, strides, padding, dil, group)


_CONV_T = {1: F.conv_transpose1d, 2: F.conv_transpose2d, 3: F.conv_transpose3d}


@op("ConvTranspose")
def _conv_transpose(a, x, w, b=None):
    spatial = x.dim() - 2
    strides = a.get("strides", [1] * spatial)
    pads = a.get("pads", [0] * 2 * spatial)
    group = a.get("group", 1)
    if group != 1:
        raise RettoWeightsError("grouped ConvTranspose not supported")
    # onnx W is [C_in, C_out, kh, kw], torch's own layout; the pads crop
    # the full (in - 1) * s + k output on each side
    out = _CONV_T[spatial](x, w, b, strides)
    idx = [slice(None), slice(None)]
    for i in range(spatial):
        idx.append(slice(pads[i], out.shape[2 + i] - pads[i + spatial]))
    return out[tuple(idx)]


@op("BatchNormalization")
def _batchnorm(a, x, scale, b, mean, var):
    eps = a.get("epsilon", 1e-5)
    shape = (1, -1) + (1,) * (x.dim() - 2)
    return (x - mean.reshape(shape)) * (
        scale.reshape(shape) / torch.sqrt(var + eps).reshape(shape)
    ) + b.reshape(shape)


_MAXPOOL = {1: F.max_pool1d, 2: F.max_pool2d, 3: F.max_pool3d}


@op("MaxPool")
def _maxpool(a, x):
    k = a["kernel_shape"]
    s = a.get("strides", [1] * len(k))
    x = F.pad(x, _torch_pads(_pool_padding(a, len(k))), value=-math.inf)
    return _MAXPOOL[len(k)](x, k, s)


def _window_sum(x: torch.Tensor, k: list[int], s: list[int]) -> torch.Tensor:
    """Sum over each pooling window of an already padded [N, C, *spatial]
    tensor (``lax.reduce_window`` with ``add``)."""
    if len(k) == 1:
        return F.avg_pool2d(x[:, :, None], (1, k[0]), (1, s[0]), divisor_override=1)[:, :, 0]
    pool = F.avg_pool2d if len(k) == 2 else F.avg_pool3d
    return pool(x, k, s, divisor_override=1)


@op("AveragePool")
def _avgpool(a, x):
    k = a["kernel_shape"]
    s = a.get("strides", [1] * len(k))
    pads = _torch_pads(_pool_padding(a, len(k)))
    summed = _window_sum(F.pad(x, pads), k, s)
    if a.get("count_include_pad", 0):
        return summed / math.prod(k)
    # divide by the count of non-pad cells of each window
    ones = torch.ones((1, 1, *x.shape[2:]), dtype=x.dtype, device=x.device)
    counts = _window_sum(F.pad(ones, pads), k, s)[0, 0]
    return summed / counts


@op("GlobalAveragePool")
def _gap(a, x):
    return torch.mean(x, dim=tuple(range(2, x.dim())), keepdim=True)


def _triangle(x: torch.Tensor) -> torch.Tensor:
    return torch.clamp(1.0 - torch.abs(x), min=0.0)


def _keys_cubic(x: torch.Tensor) -> torch.Tensor:
    x = torch.abs(x)
    out = ((1.5 * x - 2.5) * x) * x + 1.0
    out = torch.where(x >= 1.0, ((-0.5 * x + 2.5) * x - 4.0) * x + 2.0, out)
    return torch.where(x >= 2.0, torch.zeros_like(x), out)


def _weight_mat(m: int, n: int, kernel, device) -> torch.Tensor:
    """``jax.image``'s ``compute_weight_mat`` for a resize of ``m`` samples to
    ``n`` (scale n/m, no translation, antialiased): [m, n] float32."""
    inv_scale = 1.0 / (n / m)
    kernel_scale = max(inv_scale, 1.0)
    sample_f = (torch.arange(n, dtype=torch.float32, device=device) + 0.5) * inv_scale - 0.5
    x = torch.abs(sample_f[None, :] - torch.arange(m, dtype=torch.float32, device=device)[:, None])
    weights = kernel(x / kernel_scale)
    total = torch.sum(weights, dim=0, keepdim=True)
    weights = torch.where(torch.abs(total) > 1000.0 * float(np.finfo(np.float32).eps),
                          weights / torch.where(total != 0, total, torch.ones_like(total)),
                          torch.zeros_like(weights))
    keep = (sample_f >= -0.5) & (sample_f <= m - 0.5)
    return torch.where(keep[None, :], weights, torch.zeros_like(weights))


@op("Resize")
def _resize(a, x, roi=None, scales=None, sizes=None):
    mode = a.get("mode", "nearest")
    if sizes is not None and np.size(_np(sizes)):
        out_shape = _ints(sizes)
    else:
        sc = np.atleast_1d(_np(scales)).astype(np.float64)
        out_shape = [int(math.floor(d * s)) for d, s in zip(x.shape, sc)]
    kernel = {"nearest": None, "linear": _triangle, "cubic": _keys_cubic}[mode]
    # jax.image.resize: every axis whose size changes, in order
    for d, (m, n) in enumerate(zip(x.shape, out_shape)):
        if m == n:
            continue
        if kernel is None:  # half-pixel centres: floor((i + 0.5) * m / n)
            pos = (torch.arange(n, dtype=torch.float32, device=x.device) + 0.5) * float(m) / float(n)
            x = x.index_select(d, torch.floor(pos).to(torch.int64))
        else:
            w = _weight_mat(m, n, kernel, x.device).to(x.dtype)
            x = torch.tensordot(x, w, dims=([d], [0])).movedim(-1, d)
    return x


# ---------------------------------------------------------------------- #


# Structural ops that may be constant-folded on host during tracing.
_FOLDABLE = {
    "Shape", "Gather", "Slice", "Concat", "Unsqueeze", "Squeeze", "Cast",
    "Constant", "ConstantOfShape", "Range", "Add", "Sub", "Mul", "Div",
    "Reshape", "Transpose", "Expand", "Identity",
}
# Arg positions that MUST be concrete (shape-like); when the producing
# subgraph folded statically, the np value is routed here even though the
# same tensor also exists as a device tensor in params.
_STATIC_ARGS: dict[str, set[int]] = {
    "Reshape": {1}, "Slice": {1, 2, 3, 4}, "Resize": {1, 2, 3},
    "Expand": {1}, "Unsqueeze": {1}, "Squeeze": {1},
    "ConstantOfShape": {0}, "Range": {0, 1, 2}, "Split": {1},
    "Pad": {1, 2}, "ReduceMean": {1}, "ReduceSum": {1}, "ReduceMax": {1},
    "ReduceMin": {1}, "Tile": {1},
}


class OnnxFunction:
    """A parsed ONNX graph, callable as ``fn(params, *inputs)`` on tensors.

    Two-level evaluation, as in the JAX bridge: a host pass folds the
    shape-computation subgraphs (all-static structural nodes) with NumPy,
    and the torch pass takes those values at shape-like argument positions,
    while the heavy tensors stay device tensors.  ``params`` maps each
    initializer name to its tensor on the inputs' device (``self.params``
    holds them as NumPy; a NumPy value passed there is put on the device at
    each call)."""

    def __init__(self, model: OnnxModel):
        self.model = model
        g = model.graph
        self.params: dict[str, np.ndarray] = {
            name: tensor_to_numpy(t) for name, t in g.initializers.items()
        }
        self.input_names = [
            vi.name for vi in g.inputs if vi.name not in self.params
        ]
        self.output_names = [vi.name for vi in g.outputs]
        self._consts = self._fold_constants()
        # device tensors of folded values (_device_twin)
        self._on_device: dict[tuple, torch.Tensor] = {}

    def _fold_constants(self) -> dict[str, Any]:
        """The values that depend on no graph input, folded once."""
        senv: dict[str, Any] = dict(self.params)
        for node in self.model.graph.nodes:
            fn = _Ops.registry.get(node.op_type)
            if (fn is None or node.op_type not in _FOLDABLE
                    or not all((not i) or i in senv for i in node.inputs)):
                continue
            try:
                out = fn(node.attrs, *[senv[i] if i else None for i in node.inputs])
            except Exception:  # noqa: BLE001 - left to the call
                continue
            outs = out if isinstance(out, tuple) else (out,)
            if all(_static(v) for v in outs):
                senv.update(zip(node.outputs, outs))
        return {k: v for k, v in senv.items() if k not in self.params}

    def prepare(self, device: str | torch.device) -> None:
        """Put every input-independent folded value on ``device`` now, so a
        call that a CUDA graph captures uploads nothing."""
        device = torch.device(device)
        for name, v in self._consts.items():
            self._device_twin(name, v, device)

    def _device_twin(self, name: str, v: Any, device: torch.device) -> torch.Tensor:
        """The device tensor of the host value ``v`` of ``name``: a build-time
        constant by its name, a shape-dependent fold by its value."""
        a = np.asarray(v)
        if name in self._consts:
            key: tuple = (name, str(device))
        else:
            key = (name, a.dtype.str, a.shape, a.tobytes(), str(device))
        t = self._on_device.get(key)
        if t is None:
            t = self._on_device[key] = _device_value(a, device)
        return t

    def __call__(self, params: dict[str, Any], *inputs):
        device = next((v.device for v in (*inputs, *params.values())
                       if isinstance(v, torch.Tensor)), torch.device("cpu"))
        env: dict[str, Any] = {
            k: (v if isinstance(v, torch.Tensor) else _device_value(v, device))
            for k, v in params.items()
        }
        senv: dict[str, Any] = dict(self.params)
        senv.update(self._consts)
        env.update(self._consts)
        for name, val in zip(self.input_names, inputs):
            env[name] = val
            if _static(val):
                senv[name] = np.asarray(val)
        for node in self.model.graph.nodes:
            fn = _Ops.registry.get(node.op_type)
            if fn is None:
                raise RettoWeightsError(
                    f"onnx bridge: unsupported op {node.op_type!r} "
                    f"(node {node.name!r})"
                )
            if node.outputs and node.outputs[0] in self._consts:
                continue  # folded at build time
            # Shape works on device tensors too (shapes are static)
            if node.op_type in _FOLDABLE and all(
                (not i) or (i in senv) or (node.op_type == "Shape" and i in env)
                for i in node.inputs
            ):
                try:
                    sargs = [
                        (senv.get(i, env.get(i)) if i else None)
                        for i in node.inputs
                    ]
                    sout = fn(node.attrs, *sargs)
                    souts = sout if isinstance(sout, tuple) else (sout,)
                    if all(_static(v) for v in souts):
                        for name, val in zip(node.outputs, souts):
                            senv[name] = val
                            env[name] = val
                        continue
                except Exception:  # noqa: BLE001 - fall through to torch
                    pass
            static_pos = _STATIC_ARGS.get(node.op_type, set())
            args = []
            for k, name in enumerate(node.inputs):
                if not name:
                    args.append(None)
                elif k in static_pos and name in senv:
                    args.append(senv[name])
                else:
                    args.append(env[name])
            # these handlers compute host values on host inputs, as the JAX
            # bridge's do; every other op takes device tensors
            host_ok = node.op_type in ("Floor", "Ceil", "Round", "Min", "Max")
            if not (host_ok and all(v is None or _static(v) for v in args)):
                # a host value at a tensor position: its device twin
                args = [
                    self._device_twin(name, v, device)
                    if v is not None and _static(v) and k not in static_pos else v
                    for k, (name, v) in enumerate(zip(node.inputs, args))
                ]
            out = fn(node.attrs, *args)
            outs = out if isinstance(out, tuple) else (out,)
            for name, val in zip(node.outputs, outs):
                env[name] = val
        result = tuple(env[n] for n in self.output_names)
        return result if len(result) > 1 else result[0]


def build_fn(data: bytes) -> tuple[OnnxFunction, dict[str, np.ndarray]]:
    """Parse serialized ONNX -> (callable, params).  Call as
    ``fn(params_on_device, x)`` with ``params`` as device tensors
    (``pipeline.onnx_engine.OnnxEngine`` does so)."""
    fn = OnnxFunction(parse_model(data))
    return fn, fn.params


def load_onnx(path) -> tuple[OnnxFunction, dict[str, np.ndarray]]:
    return build_fn(Path(path).read_bytes())
