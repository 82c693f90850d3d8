"""Resize dimension arithmetic — the exact integer semantics of the
reference's ImageHelper (retto-core/src/image_helper.rs),
factored into pure functions shared by the host (PIL) and device (XLA)
resize paths.  Bit-compat of box coordinates depends on these formulas.


Port copy of ``retto_tpu/image/resize.py``: the port imports nothing of the JAX
package, so it keeps its own copy of this host-only module."""

from __future__ import annotations

import math

from ..config import LimitType

__all__ = ["resize_both_dims", "resize_either_dims", "rec_resize_dims"]


def _round_half_away(v: float) -> int:
    """Rust f32::round semantics (round half away from zero); Python's
    round() is banker's rounding and would diverge on exact halves."""
    return int(math.floor(v + 0.5)) if v >= 0 else -int(math.floor(-v + 0.5))


def resize_both_dims(
    h: int, w: int, max_side_len: int, min_side_len: int
) -> tuple[int, int, float, float]:
    """Target dims of the session's initial clamp-resize
    (ref: image_helper.rs:106-148 ``resize_both``).

    Returns (resize_h, resize_w, ratio_h, ratio_w) where ratio = ori/resized
    (the reference returns these ratios for later box rescaling).

    Reference quirks kept:
    * the max branch uses integer division ``floor(h*scale) / 32`` (floor);
      the min branch uses ``round(floor(h*scale) / 32.0)`` (round) —
      image_helper.rs:118-122 vs :133-137;
    * when both branches fire, the min branch recomputes from the ORIGINAL
      dims and wins (image_helper.rs:127-146).
    """
    rh, rw = h, w
    ratio_h = ratio_w = 1.0
    fh, fw = float(h), float(w)
    if max(h, w) > max_side_len:
        scale = float(max_side_len) / max(fh, fw)
        rh = max(int(math.floor(fh * scale)) // 32, 1) * 32
        rw = max(int(math.floor(fw * scale)) // 32, 1) * 32
        ratio_h = fh / rh
        ratio_w = fw / rw
    if min(h, w) < min_side_len:
        scale = float(min_side_len) / min(fh, fw)
        rh = _round_half_away(math.floor(fh * scale) / 32.0) * 32
        rw = _round_half_away(math.floor(fw * scale) / 32.0) * 32
        ratio_h = fh / rh if rh else 1.0
        ratio_w = fw / rw if rw else 1.0
    return rh, rw, ratio_h, ratio_w


def resize_either_dims(
    h: int, w: int, limit_type: LimitType, limit_side_len: int
) -> tuple[int, int]:
    """Target dims of the det-stage resize (ref: image_helper.rs:150-174
    ``resize_either``): clamp one side to ``limit_side_len`` then snap each
    dim to round(floor(dim*ratio)/32)*32.

    The reference can produce 0 here for tiny inputs (Rust would then panic
    building the image); we clamp to 32 as a safety floor and keep all other
    arithmetic identical.
    """
    if limit_type == LimitType.MAX:
        ratio = float(limit_side_len) / max(h, w) if max(h, w) > limit_side_len else 1.0
    else:
        ratio = float(limit_side_len) / min(h, w) if min(h, w) < limit_side_len else 1.0
    rh = _round_half_away(math.floor(h * ratio) / 32.0) * 32
    rw = _round_half_away(math.floor(w * ratio) / 32.0) * 32
    return max(rh, 32), max(rw, 32)


def rec_resize_dims(
    h: int,
    w: int,
    img_h: int,
    img_w: int,
    max_wh_ratio: float | None = None,
) -> tuple[int, int]:
    """Per-crop resize dims for the cls/rec normalize step
    (ref: image_helper.rs:176-209 ``resize_norm_image``).

    Returns (resized_w, target_w): the crop is aspect-resized to
    (img_h, resized_w) then right-padded with zeros to target_w.
    * target_w = int(img_h * max_wh_ratio) when a ratio is given (rec path,
      truncation — image_helper.rs:180-183), else img_w (cls path);
    * resized_w = min(target_w, ceil(img_h * w / h)) — image_helper.rs:185.
    """
    target_w = int(img_h * max_wh_ratio) if max_wh_ratio is not None else img_w
    resized_w = min(target_w, int(math.ceil(img_h * float(w) / float(h))))
    return max(resized_w, 1), max(target_w, 1)
