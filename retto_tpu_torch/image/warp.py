"""Batched crop warps on the device (PyTorch).

Port of ``retto_tpu/image/warp.py``: the gather warp for arbitrary quads
(``warp_crops_multi``/``_warp_impl``, :101-160) and the 1-D sampling
matrices of the separable warp (``_axis_matrix``, :164-180).  Every
out-of-range bilinear tap takes the fill value, judged against the
image's VALID extent ``valid_hw`` and not against the padded tensor
(``F.grid_sample`` has no per-tap fill of that kind).
"""

from __future__ import annotations

import torch

__all__ = ["warp_crops_multi", "_axis_matrix"]


def warp_crops_multi(
    images: torch.Tensor,
    img_idx: torch.Tensor,
    homographies: torch.Tensor,
    valid_hw: torch.Tensor,
    out_h: int,
    out_w: int,
    fill: float = 255.0,
) -> torch.Tensor:
    """images [B, H, W, C]; img_idx [N]; homographies [N, 3, 3]
    (dest -> source); valid_hw [B, 2].  Returns [N, out_h, out_w, C] f32
    bilinear samples of ``images[img_idx[n]]``."""
    b, hh, ww, ch = images.shape
    dev = images.device
    flat = images.to(torch.float32).reshape(b * hh * ww, ch)
    idx = img_idx.to(torch.long)
    vh = valid_hw[idx, 0].to(torch.float32)[:, None, None]
    vw = valid_hw[idx, 1].to(torch.float32)[:, None, None]
    ys = torch.arange(out_h, dtype=torch.float32, device=dev)
    xs = torch.arange(out_w, dtype=torch.float32, device=dev)
    gy, gx = torch.meshgrid(ys, xs, indexing="ij")
    dst = torch.stack([gx, gy, torch.ones_like(gx)], dim=-1).reshape(-1, 3)  # [P, 3]
    src = torch.matmul(dst, homographies.to(torch.float32).transpose(1, 2))  # [N, P, 3]
    sx = (src[..., 0:1] / src[..., 2:3])  # [N, P, 1]
    sy = (src[..., 1:2] / src[..., 2:3])
    x0 = torch.floor(sx)
    y0 = torch.floor(sy)
    fx = sx - x0
    fy = sy - y0

    def sample(xi: torch.Tensor, yi: torch.Tensor) -> torch.Tensor:
        inb = (xi >= 0) & (xi < vw) & (yi >= 0) & (yi < vh)
        xi_c = torch.minimum(torch.clamp(xi, min=0), vw - 1).to(torch.long)
        yi_c = torch.minimum(torch.clamp(yi, min=0), vh - 1).to(torch.long)
        v = flat[((idx[:, None, None] * hh + yi_c) * ww + xi_c)[..., 0]]  # [N, P, C]
        return torch.where(inb, v, torch.full_like(v, fill))

    v00 = sample(x0, y0)
    v01 = sample(x0 + 1, y0)
    v10 = sample(x0, y0 + 1)
    v11 = sample(x0 + 1, y0 + 1)
    top = v00 * (1 - fx) + v01 * fx
    bot = v10 * (1 - fx) + v11 * fx
    out = top * (1 - fy) + bot * fy
    return out.reshape(-1, out_h, out_w, ch)


def _axis_matrix(
    o: torch.Tensor, s: torch.Tensor, src_size: int, dst_size: int, valid: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-crop 1-D bilinear sampling matrix [N, dst_size, src_size] for
    p(d) = o + d*s (s < 0 is the 180-degree flip), with taps outside
    [0, valid) dropped, and its row tap-mass [N, dst_size]; the caller
    blends the missing mass with the fill, which equals the gather warp's
    per-tap fill (warp.py:164-180)."""
    dev = o.device
    d = torch.arange(dst_size, dtype=torch.float32, device=dev)[None, :, None]
    j = torch.arange(src_size, dtype=torch.float32, device=dev)[None, None, :]
    p = o[:, None, None] + d * s[:, None, None]
    w = torch.clamp(1.0 - torch.abs(p - j), min=0.0) * (j < valid[:, None, None])
    return w, w.sum(dim=2)
