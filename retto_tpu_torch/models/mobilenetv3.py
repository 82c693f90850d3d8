"""MobileNetV3 backbone and the angle classifier (PyTorch).

Port of ``retto_tpu/models/mobilenetv3.py``: ``ResidualUnit`` (:55-78),
``MobileNetV3`` (:81-120, ``LARGE_CFG`` and ``SMALL_CFG`` at :21-52) and
``ClsModel`` (:123-167) with both architectures: ``arch="mbv3"``
(MobileNetV3-small, scale 0.35, last 576) and ``arch="dense"`` (the 4x4
space-to-depth net the shipped ``cls.npz`` uses).  MobileNetV3-large is
also the ``mobilenetv3`` det backbone (``models.dbnet``).
"""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from .common import ComputeModel, ConvBNAct, Dense, SEModule, make_divisible, mean_f32, space_to_depth

__all__ = ["ClsModel", "LARGE_CFG", "MobileNetV3", "ResidualUnit", "SMALL_CFG"]

# (kernel, expand, out, use_se, act, stride)
LARGE_CFG = (
    (3, 16, 16, False, "relu", 1),
    (3, 64, 24, False, "relu", 2),
    (3, 72, 24, False, "relu", 1),
    (5, 72, 40, True, "relu", 2),
    (5, 120, 40, True, "relu", 1),
    (5, 120, 40, True, "relu", 1),
    (3, 240, 80, False, "hardswish", 2),
    (3, 200, 80, False, "hardswish", 1),
    (3, 184, 80, False, "hardswish", 1),
    (3, 184, 80, False, "hardswish", 1),
    (3, 480, 112, True, "hardswish", 1),
    (3, 672, 112, True, "hardswish", 1),
    (5, 672, 160, True, "hardswish", 2),
    (5, 960, 160, True, "hardswish", 1),
    (5, 960, 160, True, "hardswish", 1),
)

SMALL_CFG = (
    (3, 16, 16, True, "relu", 2),
    (3, 72, 24, False, "relu", 2),
    (3, 88, 24, False, "relu", 1),
    (5, 96, 40, True, "hardswish", 2),
    (5, 240, 40, True, "hardswish", 1),
    (5, 240, 40, True, "hardswish", 1),
    (5, 120, 48, True, "hardswish", 1),
    (5, 144, 48, True, "hardswish", 1),
    (5, 288, 96, True, "hardswish", 2),
    (5, 576, 96, True, "hardswish", 1),
    (5, 576, 96, True, "hardswish", 1),
)


class ResidualUnit(nn.Module):
    """1x1 expand, depthwise ``kernel`` conv, optional SE, 1x1 project; the
    skip when the stride is 1 and the widths agree (mobilenetv3.py:55-78)."""

    def __init__(self, in_ch: int, kernel: int, expand_ch: int, out_ch: int,
                 use_se: bool, act: str, stride: int):
        super().__init__()
        self.ConvBNAct_0 = ConvBNAct(in_ch, expand_ch, 1, 1, act=act)
        self.ConvBNAct_1 = ConvBNAct(expand_ch, expand_ch, kernel, stride,
                                     groups=expand_ch, act=act)
        self.use_se = use_se
        if use_se:
            self.SEModule_0 = SEModule(expand_ch)
        self.ConvBNAct_2 = ConvBNAct(expand_ch, out_ch, 1, 1, act="none")
        self.skip = stride == 1 and in_ch == out_ch

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.ConvBNAct_1(self.ConvBNAct_0(x))
        if self.use_se:
            y = self.SEModule_0(y)
        y = self.ConvBNAct_2(y)
        return x + y if self.skip else y


class MobileNetV3(nn.Module):
    """NCHW MobileNetV3 (mobilenetv3.py:81-120).  With ``feature_strides``
    it returns the maps at those strides (each taken before the unit that
    leaves it, the last after the final conv), else the final map."""

    def __init__(self, cfg: Sequence = SMALL_CFG, scale: float = 0.35, last_ch: int = 576,
                 feature_strides: Sequence[int] | None = None):
        super().__init__()
        self.feature_strides = None if feature_strides is None else tuple(feature_strides)
        c = make_divisible(16 * scale)
        self.ConvBNAct_0 = ConvBNAct(3, c, 3, 2, act="hardswish")
        self.taps: list[int | None] = []  # the stride captured before each unit
        chs: dict[int, int] = {}
        stride = 2
        for i, (k, exp, out, se, act, s) in enumerate(cfg):
            tap = s == 2 and self.feature_strides and stride in self.feature_strides
            self.taps.append(stride if tap else None)
            if tap:
                chs[stride] = c
            stride *= s
            out_ch = make_divisible(out * scale)
            setattr(self, f"ResidualUnit_{i}",
                    ResidualUnit(c, k, make_divisible(exp * scale), out_ch, se, act, s))
            c = out_ch
        self.n_units = len(cfg)
        self.last_stride = stride
        chs[stride] = make_divisible(last_ch * scale)
        self.ConvBNAct_1 = ConvBNAct(c, chs[stride], 1, 1, act="hardswish")
        self.feature_channels = (tuple(chs[s] for s in self.feature_strides)
                                 if self.feature_strides else (chs[stride],))

    def forward(self, x: torch.Tensor):
        feats: dict[int, torch.Tensor] = {}
        x = self.ConvBNAct_0(x)
        for i, tap in enumerate(self.taps):
            if tap is not None:
                feats[tap] = x
            x = getattr(self, f"ResidualUnit_{i}")(x)
        x = self.ConvBNAct_1(x)
        feats[self.last_stride] = x
        if self.feature_strides is not None:
            return [feats[s] for s in self.feature_strides]
        return x


class ClsModel(ComputeModel):
    """NCHW f32 [N, 3, 48, 192] -> softmax probs f32 [N, num_classes]
    (engine contract, worker.rs:71).  ``arch="mbv3"``: MobileNetV3-small at
    ``scale``, global mean, Dense; ``arch="dense"``: 4x4 space-to-depth,
    four dense 3x3 ConvBNActs at ``width`` / 2 ``width``, mean, Dense."""

    def __init__(self, num_classes: int = 2, scale: float = 0.35, arch: str = "mbv3",
                 width: int = 128, dtype: torch.dtype | None = None):
        super().__init__(dtype)
        self.arch = arch
        if arch == "dense":
            w = width
            self.ConvBNAct_0 = ConvBNAct(3 * 16, w, 3, 1, act="relu")  # after 4x4 s2d
            self.ConvBNAct_1 = ConvBNAct(w, 2 * w, 3, 2, act="relu")
            self.ConvBNAct_2 = ConvBNAct(2 * w, 2 * w, 3, 1, act="relu")
            self.ConvBNAct_3 = ConvBNAct(2 * w, 2 * w, 3, 2, act="relu")
            feat_ch = 2 * w
        elif arch == "mbv3":
            self.MobileNetV3_0 = MobileNetV3(SMALL_CFG, scale, last_ch=576)
            feat_ch = self.MobileNetV3_0.feature_channels[0]
        else:
            raise ValueError(f"unknown cls arch {arch!r}")
        self.Dense_0 = Dense(feat_ch, num_classes)
        self.finish_init()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.arch == "dense":
            x = space_to_depth(x, 4)  # [N, 48, 12, 48]
            for conv in (self.ConvBNAct_0, self.ConvBNAct_1, self.ConvBNAct_2,
                         self.ConvBNAct_3):
                x = conv(x)
        else:
            x = self.MobileNetV3_0(x)
        x = mean_f32(x, (2, 3)).flatten(1).to(x.dtype)
        # the logits reach the softmax as the unrounded float32 bias add
        return torch.softmax(self.Dense_0(x, f32_out=True), dim=-1)
