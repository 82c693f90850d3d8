"""Device-side half of the DB postprocess (PyTorch).

Port of ``retto_tpu/ops/db_post.py``: threshold + 2x2 up-left dilation
(cv2 semantics, det_processor.rs:128-138, :286-292) and the W-packed
1-bit layout.  The fused pipeline takes this path for map shapes off the
kernel's 64 x 128 grid (device_pipeline.py:481-484); on the grid it takes
``ops.db_pack``.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

__all__ = ["binarize_dilate", "binarize_dilate_packed", "unpack_mask"]


def binarize_dilate(
    pred: torch.Tensor, thresh: float = 0.3, use_dilation: bool = True
) -> torch.Tensor:
    """prob map [..., H, W] -> uint8 mask [H, W].  The compare runs in the
    map's dtype (the threshold rounds to it, as a weakly typed JAX scalar
    does); the dilation is a max over the up-left 2x2 window with zero
    padding above and to the left."""
    pred2d = pred.reshape(pred.shape[-2:])
    # a Python scalar, rounded on the host: no host-to-device copy, so the
    # op is safe inside a CUDA-graph capture
    mask = pred2d > float(torch.tensor(thresh, dtype=pred2d.dtype))
    if use_dilation:
        padded = F.pad(mask.to(torch.float32)[None, None], (1, 0, 1, 0))
        mask = F.max_pool2d(padded, 2, stride=1)[0, 0] > 0
    return mask.to(torch.uint8)


def binarize_dilate_packed(
    pred: torch.Tensor, thresh: float = 0.3, use_dilation: bool = True
) -> torch.Tensor:
    """Like :func:`binarize_dilate`, bit-packed along W: uint8
    [H, ceil(W/8)], big-endian (``numpy.packbits``-compatible)."""
    mask = binarize_dilate(pred, thresh, use_dilation)
    h, w = mask.shape
    pad = (-w) % 8
    if pad:
        mask = F.pad(mask, (0, pad))
    weights = 1 << torch.arange(7, -1, -1, dtype=torch.int32, device=mask.device)
    return (mask.reshape(h, -1, 8).to(torch.int32) * weights).sum(dim=-1).to(torch.uint8)


def unpack_mask(packed: np.ndarray, w: int) -> np.ndarray:
    """Host-side inverse of :func:`binarize_dilate_packed` -> bool [H, w]."""
    return np.unpackbits(np.asarray(packed), axis=1)[:, :w].astype(bool)
