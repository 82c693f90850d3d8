"""Plain float32 forwards of the three OCR models, read straight from the
Flax checkpoints (``trained_weights/*.npz``, flat ``::``-joined keys).

These are the benchmark's yardstick, written from the architectures'
descriptions and independent of the program under test: plain ``torch``
ops (``F.conv2d``, ``F.linear``, ``einsum``), NCHW, float32 with TF32 off.

* det: DBNet with the ``tpu_v2`` backbone (an 8 x 8 space-to-depth stem,
  one 3 x 3 conv and ``depths[i]`` residual blocks per stage), a concat
  FPN and a head whose 1 x 1 conv gives 16 logit channels that a
  depth-to-space turns into the stride-2 logit map;
* cls: the dense angle classifier (4 x 4 space-to-depth, four 3 x 3 convs,
  mean, dense, softmax);
* rec: SVTR-LCNet (a stem conv, depthwise-separable blocks with
  squeeze-and-excitation on the last block of each stage, the mean over
  the height, a dense projection, pre-norm self-attention blocks, a dense
  CTC head) returning logits.

Every conv uses TensorFlow's SAME padding (the odd pixel after), BatchNorm
uses the running statistics with eps 1e-5, LayerNorm eps 1e-6, GELU the
tanh form.

``Precision`` decides what happens to each tensor a layer computes and
to the operands of each conv, dense and attention product: nothing
(``"float32"``), or a round trip through float8 e4m3 with one scale per
tensor (``"fp8"``): the models computed in the precision below the
configuration's bfloat16, the control that the comparison must fail.
"""

from __future__ import annotations

import math
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

__all__ = ["Precision", "load_flat", "DetRef", "ClsRef", "RecRef"]

_FP8_MAX = 448.0  # the largest finite float8 e4m3fn value


class Precision:
    """The rounding applied to each layer's output and to each operand of
    a contraction: ``"float32"`` keeps them, ``"fp8"`` rounds each through
    float8 e4m3fn after scaling the tensor's largest magnitude to the
    format's largest value."""

    def __init__(self, name: str = "float32"):
        if name not in ("float32", "fp8"):
            raise ValueError(f"unknown precision {name!r}")
        self.name = name

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        if self.name == "float32":
            return x
        amax = x.detach().abs().amax().clamp(min=1e-12)
        scale = _FP8_MAX / amax
        return (x * scale).to(torch.float8_e4m3fn).to(torch.float32) / scale


def load_flat(path: str | Path, device: torch.device) -> dict[str, torch.Tensor]:
    """A Flax checkpoint as {``"path/leaf"``: float32 tensor on ``device``},
    in Flax's layouts (HWIO kernels, [in, out] dense kernels)."""
    out = {}
    with np.load(path, allow_pickle=False) as z:
        for key in z.files:
            if key == "__meta__":
                continue
            col, *rest = key.split("::")
            name = "/".join(rest)
            if col == "batch_stats":
                name = name.replace("/mean", "/mean_stat").replace("/var", "/var_stat")
            out[name] = torch.from_numpy(np.asarray(z[key], np.float32)).to(device)
    return out


def _same_pads(size: int, k: int, s: int) -> tuple[int, int]:
    out = -(-size // s)
    total = max((out - 1) * s + k - size, 0)
    return total // 2, total - total // 2


def space_to_depth(x: torch.Tensor, b: int) -> torch.Tensor:
    """NCHW -> [N, C*b*b, H/b, W/b], channel (by*b + bx)*C + c (the NHWC
    order of the Flax models)."""
    n, c, h, w = x.shape
    x = x.reshape(n, c, h // b, b, w // b, b).permute(0, 3, 5, 1, 2, 4)
    return x.reshape(n, b * b * c, h // b, w // b)


def depth_to_space(x: torch.Tensor, b: int) -> torch.Tensor:
    n, c, h, w = x.shape
    co = c // (b * b)
    x = x.reshape(n, b, b, co, h, w).permute(0, 3, 4, 1, 5, 2)
    return x.reshape(n, co, h * b, w * b)


def upsample_nearest(x: torch.Tensor, f: int) -> torch.Tensor:
    if f == 1:
        return x
    return x.repeat_interleave(f, dim=2).repeat_interleave(f, dim=3)


def hard_swish(x: torch.Tensor) -> torch.Tensor:
    return x * torch.clamp(x + 3.0, 0.0, 6.0) / 6.0


def gelu_tanh(x: torch.Tensor) -> torch.Tensor:
    return 0.5 * x * (1.0 + torch.tanh(math.sqrt(2.0 / math.pi) * (x + 0.044715 * x ** 3)))


_ACT = {"relu": F.relu, "hardswish": hard_swish, "none": lambda x: x}


class _Net:
    def __init__(self, p: dict[str, torch.Tensor], prec: Precision):
        self.p = p
        self.q = prec

    def conv(self, x: torch.Tensor, prefix: str, stride=(1, 1), groups: int = 1,
             bias: bool = False) -> torch.Tensor:
        k = self.p[f"{prefix}/kernel"].permute(3, 2, 0, 1)  # HWIO -> OIHW
        kh, kw = k.shape[2], k.shape[3]
        ph = _same_pads(x.shape[2], kh, stride[0])
        pw = _same_pads(x.shape[3], kw, stride[1])
        x = F.pad(x, (pw[0], pw[1], ph[0], ph[1]))
        b = self.p[f"{prefix}/bias"] if bias else None
        return self.q(F.conv2d(self.q(x), self.q(k), b, stride, 0, 1, groups))

    def bn(self, x: torch.Tensor, prefix: str) -> torch.Tensor:
        p = self.p
        mul = torch.rsqrt(p[f"{prefix}/var_stat"] + 1e-5) * p[f"{prefix}/scale"]
        return ((x - p[f"{prefix}/mean_stat"][:, None, None]) * mul[:, None, None]
                + p[f"{prefix}/bias"][:, None, None])

    def cba(self, x: torch.Tensor, prefix: str, stride=(1, 1), groups: int = 1,
            act: str = "relu") -> torch.Tensor:
        y = self.conv(x, f"{prefix}/Conv_0", stride, groups)
        return self.q(_ACT[act](self.bn(y, f"{prefix}/BatchNorm_0")))

    def dense(self, x: torch.Tensor, prefix: str) -> torch.Tensor:
        w = self.p[f"{prefix}/kernel"]
        return self.q(self.q(x) @ self.q(w) + self.p[f"{prefix}/bias"])

    def layer_norm(self, x: torch.Tensor, prefix: str) -> torch.Tensor:
        return self.q(F.layer_norm(x, (x.shape[-1],), self.p[f"{prefix}/scale"],
                                   self.p[f"{prefix}/bias"], 1e-6))


class DetRef(_Net):
    """[N, 3, H, W] float32 (BGR, (x/255 - 0.5)/0.5), H % 32 == W % 32 == 0
    -> [N, H/2, W/2] stride-2 logits."""

    def __init__(self, p, prec: Precision, widths, depths):
        super().__init__(p, prec)
        self.widths, self.depths = tuple(widths), tuple(depths)

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        x = space_to_depth(x, 8)
        feats, k = [], 0
        for i, d in enumerate(self.depths):
            s = (1, 1) if i == 0 else (2, 2)
            x = self.cba(x, f"TpuBackboneV2_0/ConvBNAct_{i}", s)
            for _ in range(d):
                blk = f"TpuBackboneV2_0/TpuResBlock_{k}"
                y = self.cba(self.cba(x, f"{blk}/ConvBNAct_0"), f"{blk}/ConvBNAct_1",
                             act="none")
                x = self.q(F.relu(x + y))
                k += 1
            feats.append(x)
        ins = [self.conv(f, f"ConcatFPN_0/Conv_{i}") for i, f in enumerate(feats)]
        tops = [ins[-1]]
        for f in reversed(ins[:-1]):
            tops.append(self.q(f + upsample_nearest(tops[-1], 2)))
        tops.reverse()
        fused = torch.cat([upsample_nearest(t, 1 << i) for i, t in enumerate(tops)], dim=1)
        h = self.cba(fused, "DBHeadV2_0/ConvBNAct_0")
        logit = self.conv(h, "DBHeadV2_0/Conv_0", bias=True)
        return depth_to_space(logit, 4)[:, 0]


class ClsRef(_Net):
    """[N, 3, 48, 192] float32 -> softmax probabilities [N, classes]."""

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        x = space_to_depth(x, 4)
        for i, s in enumerate((1, 2, 1, 2)):
            x = self.cba(x, f"ConvBNAct_{i}", (s, s))
        return torch.softmax(self.dense(x.mean(dim=(2, 3)), "Dense_0"), dim=-1)


class RecRef(_Net):
    """[N, 3, 48, W] float32 -> CTC logits [N, W/8, classes]."""

    def __init__(self, p, prec: Precision, dims, depths, mixer_depth: int, num_heads: int):
        super().__init__(p, prec)
        self.dims, self.depths = tuple(dims), tuple(depths)
        self.mixer_depth, self.num_heads = mixer_depth, num_heads

    def _se(self, x: torch.Tensor, prefix: str) -> torch.Tensor:
        s = x.mean(dim=(2, 3), keepdim=True)
        s = F.relu(self.conv(s, f"{prefix}/Conv_0", bias=True))
        s = self.conv(s, f"{prefix}/Conv_1", bias=True)
        return self.q(x * torch.clamp(0.2 * s + 0.5, 0.0, 1.0))

    def _attention(self, x: torch.Tensor, prefix: str) -> torch.Tensor:
        n, t, d = x.shape
        h = self.num_heads
        q, k, v = (
            torch.einsum("ntd,dhe->nthe", self.q(x), self.q(self.p[f"{prefix}/{nm}/kernel"]))
            + self.p[f"{prefix}/{nm}/bias"]
            for nm in ("query", "key", "value"))
        q = q / math.sqrt(d // h)
        w = torch.softmax(torch.einsum("nqhe,nkhe->nhqk", self.q(q), self.q(k)), dim=-1)
        o = torch.einsum("nhqk,nkhe->nqhe", self.q(w), self.q(v))
        out = torch.einsum("nthe,hed->ntd", self.q(o), self.q(self.p[f"{prefix}/out/kernel"]))
        return self.q(out + self.p[f"{prefix}/out/bias"])

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        bb = "LCNetBackbone_0"
        x = self.cba(x, f"{bb}/ConvBNAct_0", (2, 2), act="hardswish")
        j = 0
        for dim, depth, stride in zip(self.dims, self.depths, ((2, 2), (2, 2), (2, 1), (1, 1))):
            for i in range(depth):
                blk = f"{bb}/DSConv_{j}"
                x = self.cba(x, f"{blk}/ConvBNAct_0", stride if i == 0 else (1, 1),
                             groups=x.shape[1], act="hardswish")
                if i == depth - 1:
                    x = self._se(x, f"{blk}/SEModule_0")
                x = self.cba(x, f"{blk}/ConvBNAct_1", act="hardswish")
                j += 1
        seq = self.dense(x.mean(dim=2).transpose(1, 2), "Dense_0")
        for i in range(self.mixer_depth):
            blk = f"SVTRBlock_{i}"
            seq = self.q(seq + self._attention(self.layer_norm(seq, f"{blk}/LayerNorm_0"),
                                               f"{blk}/MultiHeadDotProductAttention_0"))
            y = self.q(gelu_tanh(self.dense(self.layer_norm(seq, f"{blk}/LayerNorm_1"),
                                            f"{blk}/Dense_0")))
            seq = self.q(seq + self.dense(y, f"{blk}/Dense_1"))
        return self.dense(self.layer_norm(seq, "LayerNorm_0"), "Dense_1")
