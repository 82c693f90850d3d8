"""Device-resident training datasets (PyTorch).

Port of ``retto_tpu/train/data.py:47-268``: the rendered dataset is put on
the device ONCE as uint8, and each train step gathers its batch by index,
normalises it, augments it and (for det) draws the DB ground-truth maps
from box coordinates on the device; only a [B] index vector crosses to the
device per step.

Every tensor lives on the device the holder was built for.  Augmentation
draws its random numbers with an explicit ``torch.Generator`` on that
device; JAX's draws cannot be reproduced in torch, so each gather also
takes the draws themselves (``draws=``: gains, biases, noise, flags), which
is how tests hold it to the JAX gather exactly.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

__all__ = [
    "RecDeviceData",
    "ClsDeviceData",
    "DetDeviceData",
    "gather_rec_batch",
    "gather_cls_batch",
    "gather_det_batch",
    "db_gt_device",
    "rec_draws",
    "det_draws",
]


def _uniform(gen: torch.Generator, shape, lo: float, hi: float, device) -> torch.Tensor:
    return lo + (hi - lo) * torch.rand(shape, generator=gen, device=device)


def _normal(gen: torch.Generator, shape, device) -> torch.Tensor:
    return torch.randn(shape, generator=gen, device=device)


def _normalize(u8: torch.Tensor) -> torch.Tensor:
    """uint8 -> ``(v / 255 - 0.5) / 0.5`` in float32."""
    return (u8.float() / 255.0 - 0.5) / 0.5


@dataclass
class RecDeviceData:
    """lines uint8 [M, H, W, 3] right-padded; widths [M]; labels [M, L];
    lengths [M] (int32, as the JAX holder)."""

    lines: torch.Tensor
    widths: torch.Tensor
    labels: torch.Tensor
    lengths: torch.Tensor

    @classmethod
    def build(cls, imgs: list[np.ndarray], labels: np.ndarray, lengths: np.ndarray,
              w_max: int, device: str | torch.device) -> "RecDeviceData":
        h = imgs[0].shape[0]
        buf = np.zeros((len(imgs), h, w_max, 3), np.uint8)
        widths = np.zeros((len(imgs),), np.int32)
        for i, im in enumerate(imgs):
            w = min(im.shape[1], w_max)
            buf[i, :, :w] = im[:, :w]
            widths[i] = w
        return cls(torch.from_numpy(buf).to(device), torch.from_numpy(widths).to(device),
                   torch.from_numpy(labels.astype(np.int32)).to(device),
                   torch.from_numpy(lengths.astype(np.int32)).to(device))


def rec_draws(b: int, shape: tuple[int, ...], gen: torch.Generator, device,
              noise_sigma: float = 0.05) -> dict[str, torch.Tensor]:
    """The rec gather's augmentation draws (data.py:86-93): gain U(0.4,
    1.15), bias U(-1.1, 0.2), noise ``sigma * N(0, 1)`` of the batch's NHWC
    ``shape``, and a 0.75 flag per crop."""
    return {"gain": _uniform(gen, (b,), 0.4, 1.15, device),
            "bias": _uniform(gen, (b,), -1.1, 0.2, device),
            "noise": noise_sigma * _normal(gen, shape, device),
            "aug": torch.rand((b,), generator=gen, device=device) < 0.75}


def gather_rec_batch(data: RecDeviceData, idx: torch.Tensor,
                     generator: torch.Generator | None = None, noise_sigma: float = 0.05,
                     draws: dict[str, torch.Tensor] | None = None):
    """[B] indices -> (x [B, 3, H, W] f32 normalised and zero beyond each
    crop's width, labels, lengths).  With ``generator`` (or ``draws``, see
    :func:`rec_draws`), per-crop photometric jitter: ``clip(x * gain + bias
    + noise, -1, 1)`` on the flagged crops, the bias first clipped to
    ``[-0.6 - gain, 1 - gain]``."""
    x = _normalize(data.lines[idx])  # [B, H, W, 3]
    if draws is None and generator is not None:
        draws = rec_draws(x.shape[0], tuple(x.shape), generator, x.device, noise_sigma)
    if draws is not None:
        gain = draws["gain"].reshape(-1, 1, 1, 1)
        bias = torch.clamp(draws["bias"].reshape(-1, 1, 1, 1), -0.6 - gain, 1.0 - gain)
        y = torch.clamp(x * gain + bias + draws["noise"], -1.0, 1.0)
        x = torch.where(draws["aug"].reshape(-1, 1, 1, 1), y, x)
    col = torch.arange(x.shape[2], device=x.device)[None, None, :, None]
    x = torch.where(col < data.widths[idx][:, None, None, None], x, 0.0)
    return x.permute(0, 3, 1, 2), data.labels[idx], data.lengths[idx]


@dataclass
class ClsDeviceData:
    """lines uint8 [M, 2, H, W, 3]: both orientations, each resized on the
    host through the inference resample (data.py:114-150); widths [M]."""

    lines: torch.Tensor
    widths: torch.Tensor

    @classmethod
    def build(cls, imgs: list[np.ndarray], w_max: int,
              device: str | torch.device) -> "ClsDeviceData":
        from .synth import downsample_2tap

        h_out = 48
        buf = np.zeros((len(imgs), 2, h_out, w_max, 3), np.uint8)
        widths = np.zeros((len(imgs),), np.int32)
        for i, im in enumerate(imgs):
            tw = max(min(int(im.shape[1] * h_out / im.shape[0]), w_max), 8)
            buf[i, 0, :, :tw] = downsample_2tap(im, h_out, tw)
            buf[i, 1, :, :tw] = downsample_2tap(np.ascontiguousarray(im[::-1, ::-1]), h_out, tw)
            widths[i] = tw
        return cls(torch.from_numpy(buf).to(device), torch.from_numpy(widths).to(device))


def gather_cls_batch(data: ClsDeviceData, idx: torch.Tensor, rot: torch.Tensor,
                     gain: torch.Tensor | None = None, bias: torch.Tensor | None = None,
                     generator: torch.Generator | None = None, noise_sigma: float = 0.05,
                     noise: torch.Tensor | None = None):
    """(x [B, 3, H, W], rot): the stored orientation ``rot`` (1 = the
    180-rotated one, the positive class) of each crop; optional per-crop
    ``x * gain + bias`` jitter and, with ``generator`` (or ``noise``), per-
    pixel Gaussian noise of ``noise_sigma``, then clipped to [-1, 1]
    (data.py:153-176)."""
    x = _normalize(data.lines[idx, rot.long()])
    if gain is not None:
        x = x * gain.reshape(-1, 1, 1, 1) + bias.reshape(-1, 1, 1, 1)
        if noise is None and generator is not None:
            noise = noise_sigma * _normal(generator, tuple(x.shape), x.device)
        if noise is not None:
            x = x + noise
        x = torch.clamp(x, -1.0, 1.0)
    col = torch.arange(x.shape[2], device=x.device)[None, None, :, None]
    x = torch.where(col < data.widths[idx][:, None, None, None], x, 0.0)
    return x.permute(0, 3, 1, 2), rot


@dataclass
class DetDeviceData:
    """pages uint8 [M, S, S, 3]; boxes f32 [M, P, 4] xyxy padded with -1."""

    pages: torch.Tensor
    boxes: torch.Tensor

    @classmethod
    def build(cls, pages: list[np.ndarray], boxes: list[np.ndarray], device: str | torch.device,
              max_boxes: int = 16) -> "DetDeviceData":
        bbuf = np.full((len(pages), max_boxes, 4), -1.0, np.float32)
        for i, bx in enumerate(boxes):
            k = min(len(bx), max_boxes)
            if k:
                bbuf[i, :k] = bx[:k]
        return cls(torch.from_numpy(np.stack(pages)).to(device), torch.from_numpy(bbuf).to(device))


def db_gt_device(boxes: torch.Tensor, size_h: int, size_w: int,
                 shrink_ratio: float = 0.4) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """DB ground truth from axis-aligned boxes [..., P, 4] (invalid rows -1)
    on their device: (shrink, thresh, thresh_mask), each [..., H, W] f32
    (data.py:194-233)."""
    valid = (boxes[..., 2] > boxes[..., 0]) & (boxes[..., 3] > boxes[..., 1])
    x0, y0, x1, y1 = (boxes[..., i][..., None, None] for i in range(4))
    dev = boxes.device
    gx = torch.arange(size_w, dtype=torch.float32, device=dev)[None, :]
    gy = torch.arange(size_h, dtype=torch.float32, device=dev)[:, None]
    bw, bh = x1 - x0, y1 - y0
    area, per = bw * bh, 2 * (bw + bh)
    d = area * float(np.float32(1 - shrink_ratio ** 2)) / torch.clamp(per, min=1e-6)
    d = torch.minimum(d, torch.minimum(bw / 2 - 1, bh / 2 - 1))
    d = torch.clamp(d, min=1.0)
    v = valid[..., None, None]
    shrink_p = ((gx >= torch.floor(x0 + d)) & (gx < torch.ceil(x1 - d))
                & (gy >= torch.floor(y0 + d)) & (gy < torch.ceil(y1 - d)) & v)
    shrink = shrink_p.any(dim=-3).float()
    dx = torch.clamp(torch.maximum(x0 - gx, gx - x1), min=0.0)
    dy = torch.clamp(torch.maximum(y0 - gy, gy - y1), min=0.0)
    dist_out = torch.sqrt(dx * dx + dy * dy)
    inside = torch.minimum(torch.minimum(gx - x0, x1 - gx), torch.minimum(gy - y0, y1 - gy))
    signed = torch.where(inside > 0, -inside, dist_out)
    band = (signed.abs() <= d) & v
    val = torch.clamp(1.0 - signed.abs() / d, 0.0, 1.0)
    tmap = torch.where(band, 0.3 + 0.4 * val, torch.zeros_like(val)).amax(dim=-3)
    tmask = band.any(dim=-3).float()
    return shrink, tmap, tmask


def det_draws(b: int, shape: tuple[int, ...], gen: torch.Generator, device,
              noise_sigma: float = 0.06) -> dict[str, torch.Tensor]:
    """The det gather's augmentation draws (data.py:257-268): gain U(0.35,
    1.15), bias U(-1.2, 0.25), a per-channel tint U(-0.06, 0.06), noise
    ``sigma * N(0, 1)`` of the NHWC ``shape`` and a 0.75 flag per page."""
    return {"gain": _uniform(gen, (b,), 0.35, 1.15, device),
            "bias": _uniform(gen, (b,), -1.2, 0.25, device),
            "tint": _uniform(gen, (b, 3), -0.06, 0.06, device),
            "noise": noise_sigma * _normal(gen, shape, device),
            "aug": torch.rand((b,), generator=gen, device=device) < 0.75}


def gather_det_batch(data: DetDeviceData, idx: torch.Tensor, out_stride: int = 1,
                     generator: torch.Generator | None = None, noise_sigma: float = 0.06,
                     draws: dict[str, torch.Tensor] | None = None):
    """[B] indices -> (x [B, 3, S, S] det-normalised BGR, gt_shrink, gt_mask,
    gt_thresh, gt_thresh_mask), the GT maps at ``out_stride`` (boxes scaled
    by 1/s, the grid shrunk by s).  With ``generator`` (or ``draws``, see
    :func:`det_draws`), photometric augmentation in normalised space:
    ``clip(x * gain + bias + tint + noise, -1, 1)`` on the flagged pages."""
    x = _normalize(data.pages[idx].flip(-1))
    if draws is None and generator is not None:
        draws = det_draws(x.shape[0], tuple(x.shape), generator, x.device, noise_sigma)
    if draws is not None:
        gain = draws["gain"].reshape(-1, 1, 1, 1)
        bias = torch.clamp(draws["bias"].reshape(-1, 1, 1, 1), -0.6 - gain, 1.0 - gain)
        y = x * gain + bias + draws["tint"].reshape(-1, 1, 1, 3) + draws["noise"]
        x = torch.where(draws["aug"].reshape(-1, 1, 1, 1), torch.clamp(y, -1.0, 1.0), x)
    x = x.permute(0, 3, 1, 2)
    s_h, s_w = data.pages.shape[1], data.pages.shape[2]
    boxes = data.boxes[idx]
    if out_stride > 1:
        valid = boxes[..., 2:3] > boxes[..., 0:1]  # padded rows stay -1
        boxes = torch.where(valid, boxes / out_stride, boxes)
        s_h, s_w = s_h // out_stride, s_w // out_stride
    shrink, tmap, tmask = db_gt_device(boxes, s_h, s_w)
    return x, shrink, torch.ones_like(shrink), tmap, tmask
