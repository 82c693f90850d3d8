"""DBNet text detector, ``backbone="tpu_v2"`` path (PyTorch).

Port of ``retto_tpu/models/dbnet.py``: ``TpuBackboneV2`` (:137-167),
``ConcatFPN`` (:170-195), ``DBHeadV2`` (:198-221) and ``DetModel``
(:290-366) in inference mode.  The ``tpu`` and ``mobilenetv3`` backbones
and the train-mode DB maps are not ported yet (``build_det`` raises).

The model computes in NCHW.  ``nhwc=True`` takes the JAX package's NHWC
input straight from the fused pipeline; every output is NCHW, as in the
JAX model.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from .common import Conv, ConvBNAct, depth_to_space, space_to_depth, upsample_nearest

__all__ = ["ConcatFPN", "DBHeadV2", "DetModel", "TpuBackboneV2", "upsample_linear"]


def upsample_linear(x: torch.Tensor, factor: int) -> torch.Tensor:
    """``jax.image.resize(method="linear")`` upsampling of NCHW by an
    integer factor (dbnet.py:356-360): half-pixel centres, edge taps
    renormalised, which is ``F.interpolate(mode="bilinear",
    align_corners=False, antialias=False)`` for upscales."""
    return F.interpolate(x, scale_factor=factor, mode="bilinear",
                         align_corners=False, antialias=False)


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
    blocks (dbnet.py:137-167)."""

    def __init__(self, widths: Sequence[int] = (128, 256, 384),
                 depths: Sequence[int] = (1, 1, 1)):
        super().__init__()
        self.stages: list[list[str]] = []
        c, k = 3 * 64, 0  # RGB after the 8x8 space-to-depth
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
        x = space_to_depth(x, 8)
        feats = []
        for names in self.stages:
            for name in names:
                x = getattr(self, name)(x)
            feats.append(x)
        return feats  # strides 8, 16, 32


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
        return torch.sigmoid(logit.float())


class DetModel(nn.Module):
    """Full DBNet (inference).  ``forward`` returns the [N, 1, H, W] prob map
    (f32, upsampled from the stride-``out_stride`` head, the engine
    contract); ``raw_logits=True`` returns the stride-s LOGITS in the
    compute dtype, which the fused pipeline thresholds in logit space
    (dbnet.py:340-348).

    ``DBHeadV2_1`` is the train-time threshold head: trained checkpoints
    carry it, so the module holds it and inference never runs it."""

    def __init__(self, backbone: str = "tpu",
                 widths: Sequence[int] = (64, 128, 192, 256),
                 depths: Sequence[int] = (1, 2, 2, 2), inner_ch: int = 96,
                 head_ch: int = 64, out_stride: int = 2,
                 dtype: torch.dtype | None = None):
        super().__init__()
        if backbone != "tpu_v2":
            raise NotImplementedError(
                f"det backbone {backbone!r} is not ported yet (only 'tpu_v2')"
            )
        self.backbone = backbone
        self.out_stride = out_stride
        self.compute_dtype = dtype
        self.TpuBackboneV2_0 = TpuBackboneV2(widths, depths)
        self.ConcatFPN_0 = ConcatFPN(widths, inner_ch)
        fused_ch = inner_ch * len(widths)
        self.DBHeadV2_0 = DBHeadV2(fused_ch, head_ch, out_stride)
        self.DBHeadV2_1 = DBHeadV2(fused_ch, head_ch, out_stride)

    def forward(self, x: torch.Tensor, nhwc: bool = False,
                raw_logits: bool = False) -> torch.Tensor:
        if nhwc:
            x = x.permute(0, 3, 1, 2)
        if self.compute_dtype is not None:
            x = x.to(self.compute_dtype)
        fused = self.ConcatFPN_0(self.TpuBackboneV2_0(x))
        if raw_logits:
            return self.DBHeadV2_0(fused, return_logits=True)
        prob = self.DBHeadV2_0(fused)
        if self.out_stride > 1:
            prob = upsample_linear(prob, self.out_stride)
        return prob
