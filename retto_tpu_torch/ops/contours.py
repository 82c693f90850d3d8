"""Contour extraction from a binary mask (host, NumPy/SciPy).

Port copy of ``retto_tpu/ops/contours.py``: the port imports nothing of the JAX
package, so it keeps its own copy of this host-only module.

Replaces ``imageproc::contours::find_contours`` (Suzuki border following)
used by the reference's det postprocess (det_processor.rs:293).  Downstream
only consumes each contour through ``min_area_rect`` (i.e. through its convex
hull), so instead of tracing ordered borders we extract, per connected
component, the set of boundary pixels — the convex hull (and hence the
min-area rect) is identical, and the extraction is vectorized.

Like Suzuki's algorithm, hole borders are emitted as separate contours
(the reference iterates holes too); hole-derived candidates are then almost
always rejected by the box-score filter (mean prob inside a hole is low).
"""

from __future__ import annotations

import numpy as np
from scipy import ndimage

__all__ = ["find_contour_point_sets"]

_EIGHT = np.ones((3, 3), dtype=bool)
_FOUR = np.array([[0, 1, 0], [1, 1, 1], [0, 1, 0]], dtype=bool)


def find_contour_point_sets(
    mask: np.ndarray, max_candidates: int | None = None
) -> list[np.ndarray]:
    """Return a list of ``(N, 2)`` int32 arrays of (x, y) boundary points,
    one per outer component (8-connected, like Suzuki/imageproc) plus one
    per interior hole (4-connected background region not touching the
    border).  Deterministic order: components by label id, then holes."""
    mask = np.asarray(mask, dtype=bool)
    if not mask.any():
        return []
    h, w = mask.shape

    out: list[np.ndarray] = []

    # Outer borders: fg pixels with at least one 4-neighbor outside the mask
    # (or on the image edge).
    interior = ndimage.binary_erosion(mask, structure=_FOUR, border_value=0)
    boundary = mask & ~interior

    labels, n = ndimage.label(mask, structure=_EIGHT)
    if n:
        b_labels = np.where(boundary, labels, 0)
        ys, xs = np.nonzero(b_labels)
        ls = b_labels[ys, xs]
        order = np.argsort(ls, kind="stable")
        ys, xs, ls = ys[order], xs[order], ls[order]
        splits = np.searchsorted(ls, np.arange(2, n + 1))
        for pts_x, pts_y in zip(np.split(xs, splits), np.split(ys, splits)):
            if len(pts_x):
                out.append(
                    np.stack([pts_x, pts_y], axis=1).astype(np.int32)
                )

    # Hole borders: background regions (4-connected) that do not touch the
    # image border; their contour is the ring of fg pixels around them.
    bg_labels, bn = ndimage.label(~mask, structure=_FOUR)
    if bn:
        edge_labels = np.unique(
            np.concatenate(
                [bg_labels[0], bg_labels[-1], bg_labels[:, 0], bg_labels[:, -1]]
            )
        )
        hole_ids = np.setdiff1d(np.arange(1, bn + 1), edge_labels)
        for hid in hole_ids:
            hole = bg_labels == hid
            ring = ndimage.binary_dilation(hole, structure=_EIGHT) & mask
            ys, xs = np.nonzero(ring)
            if len(xs):
                out.append(np.stack([xs, ys], axis=1).astype(np.int32))

    if max_candidates is not None:
        out = out[:max_candidates]
    return out
