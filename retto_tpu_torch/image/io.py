"""Host-side image I/O and the compat ImageHelper.

Port copy of ``retto_tpu/image/io.py``: the port imports nothing of the JAX
package, so it keeps its own copy of this host-only module.

Counterpart of the reference's ImageHelper
(retto-core/src/image_helper.rs).  Decode always happens on
the host (PNG/JPEG bit-twiddling is not TPU work); everything downstream can
run either here (compat path, PIL) or on device (performance path, see
retto_tpu.image.ops).  The reference resizes with ``imageops::thumbnail``
(a box/area filter); we use PIL BOX for downscale and BILINEAR for upscale —
cross-library pixel equality is impossible, so parity is defined on
observable outputs with tolerance (SURVEY.md §7 "Hard parts").
"""

from __future__ import annotations

import io as _io
from typing import Optional

import numpy as np

from ..config import LimitType
from ..errors import RettoImageError
from ..geometry import PointBox
from .resize import rec_resize_dims, resize_both_dims, resize_either_dims

__all__ = ["decode_image", "ImageHelper", "perspective_coeffs"]


def decode_image(data: bytes | bytearray | memoryview | np.ndarray) -> np.ndarray:
    """Decode encoded image bytes to an RGB uint8 HWC array
    (ref: image_helper.rs:34-44 ``new_from_raw_img_flow``)."""
    if isinstance(data, np.ndarray):
        return _to_rgb_u8(data)
    # PIL only for encoded bytes: numpy pixels never need it
    from PIL import Image

    try:
        img = Image.open(_io.BytesIO(bytes(data)))
        img = img.convert("RGB")
    except Exception as e:  # noqa: BLE001 - map all decode errors
        raise RettoImageError(f"failed to decode image: {e}") from e
    return np.asarray(img, dtype=np.uint8)


def _to_rgb_u8(arr: np.ndarray) -> np.ndarray:
    if arr.ndim == 2:
        arr = np.stack([arr] * 3, axis=-1)
    if arr.ndim != 3 or arr.shape[2] not in (1, 3, 4):
        raise RettoImageError(f"unsupported raw image shape {arr.shape}")
    if arr.shape[2] == 1:
        arr = np.repeat(arr, 3, axis=2)
    elif arr.shape[2] == 4:
        arr = arr[..., :3]
    return np.ascontiguousarray(arr, dtype=np.uint8)


def _pil_resize(arr: np.ndarray, w: int, h: int) -> np.ndarray:
    """Area filter for downscale (thumbnail-like), bilinear for upscale."""
    from PIL import Image

    img = Image.fromarray(arr)
    method = Image.BOX if (w <= arr.shape[1] and h <= arr.shape[0]) else Image.BILINEAR
    return np.asarray(img.resize((w, h), method), dtype=np.uint8)


def perspective_coeffs(dst_quad: np.ndarray, src_quad: np.ndarray) -> np.ndarray:
    """Homography coefficients (a..h) mapping DEST coords -> SOURCE coords:
    src_x = (a x + b y + c) / (g x + h y + 1), likewise src_y with (d e f).

    This is the inverse-mapping convention used both by PIL's PERSPECTIVE
    transform and by the reference's warp (imageproc ``warp_into`` samples
    the input at the inverse projection — image_helper.rs:230-244).
    """
    dst = np.asarray(dst_quad, dtype=np.float64).reshape(4, 2)
    src = np.asarray(src_quad, dtype=np.float64).reshape(4, 2)
    a = []
    b = []
    for (x, y), (u, v) in zip(dst, src):
        a.append([x, y, 1, 0, 0, 0, -u * x, -u * y])
        a.append([0, 0, 0, x, y, 1, -v * x, -v * y])
        b.extend([u, v])
    try:
        return np.linalg.solve(np.asarray(a), np.asarray(b))
    except np.linalg.LinAlgError:
        # degenerate quad (collinear corners after integer rounding of a
        # sliver min-area rect) — least-squares keeps the pipeline running;
        # the garbage box is filtered downstream by box_thresh/size checks
        return np.linalg.lstsq(np.asarray(a), np.asarray(b), rcond=None)[0]


class ImageHelper:
    """Mutable host image wrapper mirroring the reference's ImageHelper
    (image_helper.rs:14-308): tracks the original size and applies the
    pipeline's resize/normalize/crop primitives."""

    __slots__ = ("img", "ori_h", "ori_w")

    def __init__(self, img: np.ndarray, ori_size: Optional[tuple[int, int]] = None):
        self.img = _to_rgb_u8(img)
        if ori_size is not None:
            self.ori_h, self.ori_w = ori_size
        else:
            self.ori_h, self.ori_w = self.img.shape[:2]

    @classmethod
    def from_bytes(cls, data: bytes) -> "ImageHelper":
        return cls(decode_image(data))

    # -- accessors (image_helper.rs:73-95) --
    def ori_size(self) -> tuple[int, int]:
        return self.ori_h, self.ori_w

    def ori_ratio(self) -> float:
        return self.ori_h / self.ori_w

    def size(self) -> tuple[int, int]:
        return self.img.shape[0], self.img.shape[1]

    def ratio(self) -> float:
        h, w = self.size()
        return h / w

    # -- resizes --
    def resize_both(self, max_side_len: int, min_side_len: int) -> tuple[float, float]:
        """Session's initial clamp resize (image_helper.rs:106-148).
        Returns (ratio_h, ratio_w) = ori/resized."""
        h, w = self.size()
        rh, rw, ratio_h, ratio_w = resize_both_dims(h, w, max_side_len, min_side_len)
        if (rh, rw) != (h, w):
            self.img = _pil_resize(self.img, rw, rh)
        return ratio_h, ratio_w

    def resize_either(self, limit_type: LimitType, limit_side_len: int) -> None:
        """Det-stage /32 resize (image_helper.rs:150-174)."""
        h, w = self.size()
        rh, rw = resize_either_dims(h, w, limit_type, limit_side_len)
        if (rh, rw) != (h, w):
            self.img = _pil_resize(self.img, rw, rh)

    def resize_norm_image(
        self, shape: tuple[int, int, int], max_wh_ratio: float | None = None
    ) -> np.ndarray:
        """Aspect-resize to height, normalize (x/255 - .5)/.5, CHW, zero-pad
        right (image_helper.rs:176-209).  Returns float32 [C, H, target_w]."""
        img_c, img_h, img_w = shape
        h, w = self.size()
        resized_w, target_w = rec_resize_dims(h, w, img_h, img_w, max_wh_ratio)
        resized = _pil_resize(self.img, resized_w, img_h).astype(np.float32)
        if img_c == 1:
            resized = resized[..., :1]
        norm = (resized / 255.0 - 0.5) / 0.5
        chw = np.transpose(norm, (2, 0, 1))
        out = np.zeros((img_c, img_h, target_w), dtype=np.float32)
        out[:, :, :resized_w] = chw
        return out

    def rgb2bgr(self) -> np.ndarray:
        """Channel swap, returns HWC uint8 (image_helper.rs:211-221)."""
        return self.img[..., ::-1]

    def get_crop_img(self, box: PointBox) -> np.ndarray:
        """Perspective-warp the quad to an upright crop
        (image_helper.rs:223-249): output size = max of opposing side pairs,
        bicubic, white fill, rotate 90° CCW if h/w >= 1.5."""
        w_crop = int(max(box.width_brc(), box.width_tlc()))
        h_crop = int(max(box.height_brc(), box.height_tlc()))
        w_crop, h_crop = max(w_crop, 1), max(h_crop, 1)
        rect = np.array(
            [[0, 0], [w_crop, 0], [w_crop, h_crop], [0, h_crop]], dtype=np.float64
        )
        coeffs = perspective_coeffs(rect, box.pts)
        from PIL import Image

        pil = Image.fromarray(self.img)
        out = pil.transform(
            (w_crop, h_crop),
            Image.PERSPECTIVE,
            tuple(coeffs),
            resample=Image.BICUBIC,
            fillcolor=(255, 255, 255),
        )
        crop = np.asarray(out, dtype=np.uint8)
        if h_crop / w_crop >= 1.5:
            crop = np.rot90(crop)  # 90° CCW == reference rotate270 (CW 270)
        return crop

    # -- rotations (image_helper.rs:252-286) --
    def rotate_180_in_place(self) -> None:
        self.img = np.ascontiguousarray(self.img[::-1, ::-1])

    def rotate_90(self) -> np.ndarray:
        return np.rot90(self.img, k=-1)  # image::rotate90 is clockwise

    def rotate_180(self) -> np.ndarray:
        return self.img[::-1, ::-1]

    def rotate_270(self) -> np.ndarray:
        return np.rot90(self.img)
