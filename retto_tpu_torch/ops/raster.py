"""Polygon rasterization + DB box scoring (host, NumPy).

Port copy of ``retto_tpu/ops/raster.py``: the port imports nothing of the JAX
package, so it keeps its own copy of this host-only module.

Replaces ``imageproc::drawing::draw_polygon_mut`` + the fold in the
reference's ``box_score_fast`` (det_processor.rs:188-221): mean probability
over the pixels inside the candidate quad's filled polygon, restricted to
the quad's bounding box.
"""

from __future__ import annotations

import numpy as np

__all__ = ["fill_convex_quad", "fill_polygon", "box_score_fast", "box_score_slow"]


def fill_convex_quad(quad: np.ndarray, h: int, w: int) -> np.ndarray:
    """Boolean mask of the filled convex quad (edges inclusive) on an
    ``(h, w)`` grid.  The quad must be ordered (either orientation); the
    candidate boxes here are min-area rects, which are always convex."""
    quad = np.asarray(quad, dtype=np.float64).reshape(4, 2)
    ys, xs = np.mgrid[0:h, 0:w]
    pts = np.stack([xs, ys], axis=-1).astype(np.float64)  # (h, w, 2)
    inside_neg = np.ones((h, w), dtype=bool)
    inside_pos = np.ones((h, w), dtype=bool)
    for i in range(4):
        a = quad[i]
        b = quad[(i + 1) % 4]
        cross = (b[0] - a[0]) * (pts[..., 1] - a[1]) - (b[1] - a[1]) * (
            pts[..., 0] - a[0]
        )
        inside_neg &= cross <= 0
        inside_pos &= cross >= 0
    return inside_neg | inside_pos


def fill_polygon(poly: np.ndarray, h: int, w: int) -> np.ndarray:
    """Boolean mask of a general (possibly concave) closed polygon on an
    ``(h, w)`` grid, even-odd rule over pixel centers (crossing-number test
    vectorized over the grid).  Degenerate horizontal edges contribute no
    crossings, matching the standard scanline convention."""
    poly = np.asarray(poly, dtype=np.float64).reshape(-1, 2)
    ys, xs = np.mgrid[0:h, 0:w]
    inside = np.zeros((h, w), dtype=bool)
    n = len(poly)
    for i in range(n):
        ax, ay = poly[i]
        bx, by = poly[(i + 1) % n]
        if ay == by:
            continue
        spans = (ay > ys) != (by > ys)
        x_int = ax + (ys - ay) * (bx - ax) / (by - ay)
        inside ^= spans & (xs < x_int)
    return inside


def box_score_fast(pred: np.ndarray, quad: np.ndarray) -> float:
    """Mean of ``pred`` inside the quad (det_processor.rs:188-221,
    ScoreMode::Fast — the only mode the reference implements).

    The quad is clamped to the bitmap, shifted into its bounding box, and
    rasterized; returns 0.0 when no pixel is covered."""
    pred = np.asarray(pred)
    h, w = pred.shape
    quad = np.asarray(quad, dtype=np.float64).reshape(4, 2)
    x_min = int(np.clip(np.floor(quad[:, 0].min()), 0, w - 1))
    x_max = int(np.clip(np.ceil(quad[:, 0].max()), 0, w - 1))
    y_min = int(np.clip(np.floor(quad[:, 1].min()), 0, h - 1))
    y_max = int(np.clip(np.ceil(quad[:, 1].max()), 0, h - 1))
    shifted = quad - np.array([x_min, y_min], dtype=np.float64)
    mask = fill_convex_quad(shifted, y_max - y_min + 1, x_max - x_min + 1)
    if not mask.any():
        return 0.0
    region = pred[y_min : y_max + 1, x_min : x_max + 1]
    return float(region[mask].mean())


def box_score_slow(pred: np.ndarray, contour: np.ndarray) -> float:
    """Mean of ``pred`` inside the ORIGINAL contour polygon (possibly
    concave), i.e. PaddleOCR's ``box_score_slow`` semantics — the
    ``ScoreMode::Slow`` the reference declares but never implements
    (det_processor.rs:20-29).  Tighter than the min-area-rect scoring for
    curved or L-shaped text regions; restricted to the contour's bbox."""
    pred = np.asarray(pred)
    h, w = pred.shape
    contour = np.asarray(contour, dtype=np.float64).reshape(-1, 2)
    x_min = int(np.clip(np.floor(contour[:, 0].min()), 0, w - 1))
    x_max = int(np.clip(np.ceil(contour[:, 0].max()), 0, w - 1))
    y_min = int(np.clip(np.floor(contour[:, 1].min()), 0, h - 1))
    y_max = int(np.clip(np.ceil(contour[:, 1].max()), 0, h - 1))
    shifted = contour - np.array([x_min, y_min], dtype=np.float64)
    mask = fill_polygon(shifted, y_max - y_min + 1, x_max - x_min + 1)
    if not mask.any():
        # a thin/degenerate contour covers no pixel centers; fall back to
        # its quad so the candidate is scored rather than dropped
        return box_score_fast(pred, _min_rect_of(contour))
    region = pred[y_min : y_max + 1, x_min : x_max + 1]
    return float(region[mask].mean())


def _min_rect_of(contour: np.ndarray) -> np.ndarray:
    from ..geometry import min_area_rect

    return min_area_rect(contour)[0]
