"""Batched crop warps on the device (PyTorch).

Port of ``retto_tpu/image/warp.py``: the reference crop's size and rotate
flag (``crop_output_size``), the per-box homographies (``crop_homographies``,
numpy on the host), the gather warp for arbitrary quads (``warp_crops`` over
one image, ``warp_crops_multi`` over a stacked batch; ``_warp_impl``,
:101-160) and the separable warp of axis-aligned boxes
(``warp_crops_separable``: two matmuls per crop over the 1-D sampling
matrices of ``_axis_matrix``, :164-212).  ``DevicePipeline`` runs the same
passes (``warp_rows``, ``warp_cols``) in bf16.  Every out-of-range bilinear
tap takes the fill value, judged against the image's VALID extent
``valid_hw`` and not against the padded tensor (``F.grid_sample`` has no
per-tap fill of that kind).  The float32 arithmetic follows the fused
multiply-adds XLA:CPU compiles the JAX warps to (float64 sums of exact
products, rounded once), so the CPU results equal the JAX package's bit
for bit (tests/test_torch_warp.py); the card runs the same ops.
"""

from __future__ import annotations

import numpy as np
import torch

from ..geometry import PointBox
from .io import perspective_coeffs

__all__ = [
    "crop_homographies",
    "warp_crops",
    "warp_crops_multi",
    "warp_crops_separable",
    "crop_output_size",
]


def crop_output_size(box: PointBox) -> tuple[int, int, bool]:
    """(h, w, rotate) of the reference's crop for this box
    (image_helper.rs:225-228, rotate-if-tall at :245-247)."""
    w = max(int(max(box.width_brc(), box.width_tlc())), 1)
    h = max(int(max(box.height_brc(), box.height_tlc())), 1)
    return h, w, h / w >= 1.5


def crop_homographies(boxes: np.ndarray, out_hw: tuple[int, int], sizes: np.ndarray
                      ) -> np.ndarray:
    """Homographies mapping OUTPUT pixel coords -> SOURCE coords, [N, 3, 3]
    float32.  boxes: [N, 4, 2] quads (clockwise from TL); sizes: [N, 2]
    (h, w) natural crop sizes.  Each crop is rendered height-fit into the
    shared (out_h, out_w) canvas, aspect preserved (warp.py:44-72)."""
    boxes = np.asarray(boxes, dtype=np.float64)
    out = np.zeros((len(boxes), 3, 3), dtype=np.float32)
    out_h = out_hw[0]
    for i, quad in enumerate(boxes):
        h_i, w_i = float(sizes[i][0]), float(sizes[i][1])
        s = out_h / h_i
        rect = np.array([[0, 0], [w_i * s, 0], [w_i * s, h_i * s], [0, h_i * s]],
                        dtype=np.float64)
        c = perspective_coeffs(rect, quad)
        out[i] = np.array([[c[0], c[1], c[2]], [c[3], c[4], c[5]], [c[6], c[7], 1.0]],
                          dtype=np.float32)
    return out


def warp_crops(image: torch.Tensor, homographies: torch.Tensor, out_h: int, out_w: int,
               fill: float = 255.0, valid_hw: torch.Tensor | None = None) -> torch.Tensor:
    """image [H, W, C] u8/f32; homographies [N, 3, 3] dest -> source.
    Returns [N, out_h, out_w, C] float32 bilinear samples, out-of-range taps
    filled with ``fill`` (the reference fills white, image_helper.rs:241).
    ``valid_hw`` ([2], optional) restricts the in-bounds region to [0,
    valid_h) x [0, valid_w) of a padded ``image``."""
    if valid_hw is None:
        valid_hw = torch.tensor(image.shape[:2], device=image.device)
    n = homographies.shape[0]
    return warp_crops_multi(image[None], torch.zeros(n, dtype=torch.long, device=image.device),
                            homographies, valid_hw.reshape(1, 2), out_h, out_w, fill)


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
    ys = torch.arange(out_h, dtype=torch.float64, device=dev)
    xs = torch.arange(out_w, dtype=torch.float64, device=dev)
    gy, gx = (g.reshape(1, -1, 1) for g in torch.meshgrid(ys, xs, indexing="ij"))
    # dst (x, y, 1) @ H^T as XLA's dot sums it: round(x*h0), then fused
    # multiply-adds of y*h1 and of h2 (float64 sums of exact products,
    # rounded once each)
    hm = homographies.to(torch.float32).to(torch.float64)[:, None]  # [N, 1, 3, 3]
    src = (gx * hm[..., 0]).float()
    src = (src.double() + gy * hm[..., 1]).float()
    src = (src.double() + hm[..., 2]).float()  # [N, P, 3]
    sx = (src[..., 0:1] / src[..., 2:3])  # [N, P, 1]
    sy = (src[..., 1:2] / src[..., 2:3])
    x0 = torch.floor(sx)
    y0 = torch.floor(sy)
    fx = sx - x0
    fy = sy - y0

    def sample(xi: torch.Tensor, yi: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        inb = (xi >= 0) & (xi < vw) & (yi >= 0) & (yi < vh)
        xi_c = torch.minimum(torch.clamp(xi, min=0), vw - 1).to(torch.long)
        yi_c = torch.minimum(torch.clamp(yi, min=0), vh - 1).to(torch.long)
        v = flat[((idx[:, None, None] * hh + yi_c) * ww + xi_c)[..., 0]]  # [N, P, C]
        return torch.where(inb, v, torch.full_like(v, fill)), inb

    def lerp(a: torch.Tensor, b: torch.Tensor, f: torch.Tensor, fuse_b) -> torch.Tensor:
        # a * (1 - f) + b * f as one fused multiply-add over the other
        # product rounded: a's product fused, or b's where ``fuse_b``
        fa = (a.double() * (1 - f).double() + (b * f).double()).float()
        fb = (b.double() * f.double() + (a * (1 - f)).double()).float()
        return torch.where(fuse_b, fb, fa)

    (v00, c00), (v01, c01) = sample(x0, y0), sample(x0 + 1, y0)
    (v10, c10), (v11, c11) = sample(x0, y0 + 1), sample(x0 + 1, y0 + 1)
    # which product XLA:CPU's loop fuses follows its branches on the taps'
    # bounds (LLVM unswitches the loop on them and hoists the products of
    # the constant fill): a's while tap 00 is in bounds; b's in the top
    # row once it is not, and everywhere once tap 01 is not either, but
    # for the bottom row while tap 10 is in bounds
    edge = ~c00 & ~c01
    top = lerp(v00, v01, fx, ~c00)
    bot = lerp(v10, v11, fx, edge & ~c10)
    return lerp(top, bot, fy, edge).reshape(-1, out_h, out_w, ch)


def _axis_matrix(
    o: torch.Tensor, s: torch.Tensor, src_size: int, dst_size: int, valid: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-crop 1-D bilinear sampling matrix [N, dst_size, src_size] for
    p(d) = o + d*s (s < 0 is the 180-degree flip), with taps outside
    [0, valid) dropped, and its row tap-mass [N, dst_size]; the caller
    blends the missing mass with the fill, which equals the gather warp's
    per-tap fill (warp.py:164-180).  XLA contracts ``o + d*s`` into one
    fused multiply-add; the product of the integer d and float32 s is
    exact in float64, so one rounding of the float64 sum gives the same
    position (tests/test_torch_warp.py holds the matrices bit for bit)."""
    dev = o.device
    d = torch.arange(dst_size, dtype=torch.float64, device=dev)[None, :, None]
    j = torch.arange(src_size, dtype=torch.float32, device=dev)[None, None, :]
    p = (o.double()[:, None, None] + d * s.double()[:, None, None]).float()
    w = torch.clamp(1.0 - torch.abs(p - j), min=0.0) * (j < valid[:, None, None])
    return w, w.sum(dim=2)


def warp_rows(wv: torch.Tensor, src: torch.Tensor) -> torch.Tensor:
    """The vertical pass ``einsum("ndh,nhwc->ndwc")`` of the separable warp:
    wv [N, D, H] sampling matrices, src [N, H, W, C] crops' source images,
    both in ``src``'s dtype, which the result keeps.  Each output sums at
    most two nonzero bilinear taps; in bf16 their products are exact in
    float32, so the bits do not depend on the summation order (in float32
    a fused multiply-add may round one product less)."""
    return torch.einsum("ndh,nhwc->ndwc", wv.to(src.dtype), src)


def warp_cols(wu: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """The horizontal pass ``einsum("new,ndwc->ndec")``: wu [N, E, W] over
    the vertical pass's [N, D, W, C] in ``t``'s dtype (two taps per output
    again)."""
    return torch.einsum("new,ndwc->ndec", wu.to(t.dtype), t)


def blend_fill(out: torch.Tensor, mass_v: torch.Tensor, mass_u: torch.Tensor,
               fill: float) -> torch.Tensor:
    """float32 ``out`` [N, D, E, C] plus the fill times the tap mass each
    output pixel lost outside the valid extent."""
    mass = mass_v[:, :, None] * mass_u[:, None, :]
    return out.to(torch.float32) + (1.0 - mass)[..., None] * fill


def warp_crops_separable(
    images: torch.Tensor,
    img_idx: torch.Tensor,
    scal: torch.Tensor,
    valid_hw: torch.Tensor,
    out_h: int,
    out_w: int,
    fill: float = 255.0,
) -> torch.Tensor:
    """Axis-aligned crop warp as two float32 matmuls per crop
    (warp.py:182-212): out = Wv @ img @ Wu^T with per-crop 1-D bilinear
    matrices.  images [B, H, W, C] u8; img_idx [N]; scal [N, 4] = (ox, sx,
    oy, sy) mapping dest (u, v) -> source (ox + u*sx, oy + v*sy); valid_hw
    [B, 2].  Returns [N, out_h, out_w, C] float32 with out-of-valid taps
    filled."""
    idx = img_idx.to(torch.long)
    src = images[idx].to(torch.float32)
    h, w = images.shape[1], images.shape[2]
    scal = scal.to(torch.float32)
    wv, mass_v = _axis_matrix(scal[:, 2], scal[:, 3], h, out_h,
                              valid_hw[idx, 0].to(torch.float32))
    wu, mass_u = _axis_matrix(scal[:, 0], scal[:, 1], w, out_w,
                              valid_hw[idx, 1].to(torch.float32))
    return blend_fill(warp_cols(wu, warp_rows(wv, src)), mass_v, mass_u, fill)
