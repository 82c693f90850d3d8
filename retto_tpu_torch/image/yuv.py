"""YUV 4:2:0 transfer codec (PyTorch device side).

Port of ``retto_tpu/image/yuv.py``: images cross the host->device link as
planar YUV 4:2:0 (1.5 B/px) and are rebuilt to RGB on the device in
float32 (JPEG/JFIF full-range BT.601).  ``rgb_to_yuv420`` is the host
encoder, a copy of the JAX package's (PIL imported inside; the fused
pipeline calls it only when the C++ pack is unavailable).
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["rgb_to_yuv420", "yuv420_to_rgb_device", "yuv_planes_to_rgb"]


def rgb_to_yuv420(img: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """HWC uint8 RGB -> (Y [H, W] u8, UV [H/2, W/2, 2] u8); H and W even.
    Chroma is 2x2 box-averaged (yuv.py:25-47)."""
    h, w, _ = img.shape
    if h % 2 or w % 2:
        raise ValueError(f"YUV420 needs even dims, got {h}x{w}")
    from PIL import Image

    im = Image.fromarray(img)
    y = np.asarray(im.convert("L"))
    half = np.asarray(im.resize((w // 2, h // 2), Image.BOX).convert("YCbCr"))
    uv = np.ascontiguousarray(half[..., 1:3])
    return y, uv


def yuv_planes_to_rgb(y: torch.Tensor, u: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Full-resolution float32 planes -> RGB float32 (0..255), [..., 3]."""
    u = u - 128.0
    v = v - 128.0
    r = y + 1.402 * v
    g = y - 0.344136 * u - 0.714136 * v
    b = y + 1.772 * u
    return torch.stack([r, g, b], dim=-1)


def yuv420_to_rgb_device(y: torch.Tensor, uv: torch.Tensor) -> torch.Tensor:
    """Y [..., H, W] + UV [..., H/2, W/2, 2] -> RGB float32 [..., H, W, 3];
    chroma upsampled 2x nearest (yuv.py:57-63)."""
    uvf = uv.to(torch.float32).repeat_interleave(2, dim=-3).repeat_interleave(2, dim=-2)
    return yuv_planes_to_rgb(y.to(torch.float32), uvf[..., 0], uvf[..., 1])
