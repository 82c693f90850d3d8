"""Angle classifier, ``arch="dense"`` (PyTorch).

Port of ``retto_tpu/models/mobilenetv3.py::ClsModel`` (:123-167) for the
dense 4x4-space-to-depth architecture the shipped ``cls.npz`` uses.  The
MobileNetV3 backbone (``arch="mbv3"``) is not ported yet.
"""

from __future__ import annotations

import torch
from torch import nn

from .common import ConvBNAct, Dense, mean_f32, space_to_depth

__all__ = ["ClsModel"]


class ClsModel(nn.Module):
    """NCHW f32 [N, 3, 48, 192] -> softmax probs f32 [N, num_classes]
    (engine contract, worker.rs:71)."""

    def __init__(self, num_classes: int = 2, arch: str = "mbv3", width: int = 128,
                 dtype: torch.dtype | None = None):
        super().__init__()
        if arch != "dense":
            raise NotImplementedError(
                f"cls arch {arch!r} is not ported yet (only 'dense')"
            )
        self.compute_dtype = dtype
        w = width
        self.ConvBNAct_0 = ConvBNAct(3 * 16, w, 3, 1, act="relu")  # after 4x4 s2d
        self.ConvBNAct_1 = ConvBNAct(w, 2 * w, 3, 2, act="relu")
        self.ConvBNAct_2 = ConvBNAct(2 * w, 2 * w, 3, 1, act="relu")
        self.ConvBNAct_3 = ConvBNAct(2 * w, 2 * w, 3, 2, act="relu")
        self.Dense_0 = Dense(2 * w, num_classes)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = space_to_depth(x, 4)  # [N, 48, 12, 48]
        for conv in (self.ConvBNAct_0, self.ConvBNAct_1, self.ConvBNAct_2,
                     self.ConvBNAct_3):
            x = conv(x)
        x = mean_f32(x, (2, 3)).flatten(1).to(x.dtype)
        # the logits reach the softmax as the unrounded float32 bias add
        return torch.softmax(self.Dense_0(x, f32_out=True), dim=-1)
