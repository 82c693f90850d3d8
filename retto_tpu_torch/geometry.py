"""Planar geometry for text boxes.

Port copy of ``retto_tpu/geometry.py``: the port imports nothing of the JAX
package, so it keeps its own copy of this host-only module.

NumPy counterpart of the reference's geometry layer
(retto-core/src/points.rs) plus the host-side geometric
algorithms the reference delegates to ``imageproc``/``geo-clipper``:

* ``Point`` / ``PointBox``  — points.rs:16-194 (quad, clockwise from top-left)
* ``order_clockwise_tl``    — the clockwise-from-TL ordering invariant
                              (points.rs:61-66)
* ``min_area_rect``         — imageproc::geometry::min_area_rect used at
                              det_processor.rs:176-186
* ``unclip``                — the Vatti polygon offset (clipper C++) used at
                              det_processor.rs:223-252
* ``sort_boxes_reading_order`` — det_processor.rs:324-333

Everything here is plain NumPy on the host: these are tiny, inherently
sequential algorithms that run on a handful of boxes per image; the heavy
pixel work stays on the TPU (see retto_tpu.ops.db_post).
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Iterable, Sequence

import numpy as np

__all__ = [
    "Point",
    "PointBox",
    "order_clockwise_tl",
    "convex_hull",
    "min_area_rect",
    "polygon_area",
    "polygon_perimeter",
    "unclip",
    "sort_boxes_reading_order",
    "scale_and_clip",
]


@dataclass(frozen=True)
class Point:
    """A point on a 2-D plane (ref: points.rs:16-41)."""

    x: float
    y: float

    def dist2(self) -> float:
        return self.x * self.x + self.y * self.y

    def range(self, other: "Point") -> float:
        """Euclidean distance (ref: points.rs:36-41)."""
        dx = float(self.x) - float(other.x)
        dy = float(self.y) - float(other.y)
        return math.sqrt(dx * dx + dy * dy)

    def to_array(self) -> np.ndarray:
        return np.array([self.x, self.y], dtype=np.float32)


class PointBox:
    """A quad of points ordered clockwise from the top-left corner
    (ref: points.rs:60-121).  Backed by a float32 ``(4, 2)`` array.
    """

    __slots__ = ("pts",)

    def __init__(self, pts: np.ndarray | Sequence[Sequence[float]]):
        arr = np.asarray(pts, dtype=np.float32)
        if arr.shape != (4, 2):
            raise ValueError(f"PointBox expects (4, 2) points, got {arr.shape}")
        self.pts = arr

    @classmethod
    def new_from_clockwise(cls, pts: Iterable[Sequence[float]]) -> "PointBox":
        return cls(np.asarray(list(pts), dtype=np.float32))

    # Corner accessors (ref: points.rs:100-121)
    @property
    def tl(self) -> Point:
        return Point(float(self.pts[0, 0]), float(self.pts[0, 1]))

    @property
    def tr(self) -> Point:
        return Point(float(self.pts[1, 0]), float(self.pts[1, 1]))

    @property
    def br(self) -> Point:
        return Point(float(self.pts[2, 0]), float(self.pts[2, 1]))

    @property
    def bl(self) -> Point:
        return Point(float(self.pts[3, 0]), float(self.pts[3, 1]))

    def points(self) -> np.ndarray:
        return self.pts

    # Side lengths (ref: points.rs:125-169)
    def height_tlc(self) -> float:
        return float(np.linalg.norm(self.pts[0] - self.pts[3]))

    def width_tlc(self) -> float:
        return float(np.linalg.norm(self.pts[0] - self.pts[1]))

    def height_brc(self) -> float:
        return float(np.linalg.norm(self.pts[1] - self.pts[2]))

    def width_brc(self) -> float:
        return float(np.linalg.norm(self.pts[3] - self.pts[2]))

    def center_point(self) -> Point:
        """Center = midpoint of the tl--br diagonal (ref: points.rs:173-177)."""
        c = (self.pts[0] + self.pts[2]) / 2.0
        return Point(float(c[0]), float(c[1]))

    def scale_and_clip(
        self, bitmap_w: float, bitmap_h: float, ori_w: float, ori_h: float
    ) -> "PointBox":
        """Rescale from bitmap coords to original-image coords, rounding and
        clamping to the image bounds (ref: points.rs:179-194).

        Unlike the Rust in-place mutation this returns a new box.
        """
        return PointBox(
            scale_and_clip(self.pts[None], bitmap_w, bitmap_h, ori_w, ori_h)[0]
        )

    def __repr__(self) -> str:  # pragma: no cover
        return f"PointBox(tl={self.tl}, tr={self.tr}, br={self.br}, bl={self.bl})"

    def __eq__(self, other: object) -> bool:
        return isinstance(other, PointBox) and bool(np.array_equal(self.pts, other.pts))


def scale_and_clip(
    boxes: np.ndarray, bitmap_w: float, bitmap_h: float, ori_w: float, ori_h: float
) -> np.ndarray:
    """Vectorized ``PointBox.scale_and_clip`` over ``(N, 4, 2)`` boxes
    (ref: points.rs:179-194): x' = clamp(round(x * ori_w / bitmap_w), 0, ori_w-1).
    """
    boxes = np.asarray(boxes, dtype=np.float64)
    inv = np.array([ori_w / bitmap_w, ori_h / bitmap_h], dtype=np.float64)
    hi = np.array([ori_w - 1.0, ori_h - 1.0], dtype=np.float64)
    out = np.clip(np.round(boxes * inv), 0.0, hi)
    return out.astype(np.float32)


def order_clockwise_tl(pts: np.ndarray) -> np.ndarray:
    """Order 4 points clockwise starting from the top-left corner — the
    ``PointBox`` invariant (ref: points.rs:61-66).  Matches the PaddleOCR
    convention: of the two leftmost points the upper one is TL and the lower
    one is BL; of the two rightmost the upper is TR, the lower is BR.
    """
    pts = np.asarray(pts, dtype=np.float32).reshape(4, 2)
    xs = np.argsort(pts[:, 0], kind="stable")
    left, right = pts[xs[:2]], pts[xs[2:]]
    tl, bl = (left[0], left[1]) if left[0, 1] <= left[1, 1] else (left[1], left[0])
    tr, br = (right[0], right[1]) if right[0, 1] <= right[1, 1] else (right[1], right[0])
    return np.stack([tl, tr, br, bl])


def convex_hull(points: np.ndarray) -> np.ndarray:
    """Convex hull (Andrew's monotone chain), counter-clockwise in a y-up
    frame (equivalently clockwise on image coordinates with y-down).
    Returns ``(M, 2)`` hull vertices.
    """
    pts = np.unique(np.asarray(points, dtype=np.float64).reshape(-1, 2), axis=0)
    if len(pts) <= 2:
        return pts
    # lexicographic sort by (x, y)
    order = np.lexsort((pts[:, 1], pts[:, 0]))
    pts = pts[order]

    def half(iterable):
        hull: list[np.ndarray] = []
        for p in iterable:
            while len(hull) >= 2:
                a, b = hull[-2], hull[-1]
                if (b[0] - a[0]) * (p[1] - a[1]) - (b[1] - a[1]) * (p[0] - a[0]) <= 0:
                    hull.pop()
                else:
                    break
            hull.append(p)
        return hull

    lower = half(pts)
    upper = half(pts[::-1])
    return np.asarray(lower[:-1] + upper[:-1])


def min_area_rect(points: np.ndarray) -> tuple[np.ndarray, float]:
    """Minimum-area enclosing rotated rectangle via rotating calipers.

    Host analog of ``imageproc::geometry::min_area_rect`` as used by
    ``get_mini_boxes`` (ref: det_processor.rs:176-186).  Returns the 4 corners
    ordered clockwise from top-left (``order_clockwise_tl``) and ``sside``.

    Reference quirk, reproduced deliberately: the reference computes
    ``sside = min(dist(tl, tr), dist(bl, br))`` (det_processor.rs:182-185) —
    the min of the *top and bottom edge* lengths, which for a rectangle are
    equal; i.e. the horizontal-ish extent, NOT PaddleOCR's ``min(w, h)``.
    We match the reference's observable filter behavior.
    """
    pts = np.asarray(points, dtype=np.float64).reshape(-1, 2)
    if len(pts) == 0:
        raise ValueError("min_area_rect of empty point set")
    hull = convex_hull(pts)
    if len(hull) == 1:
        box = np.repeat(hull, 4, axis=0)
        return box.astype(np.float32), 0.0
    if len(hull) == 2:
        # degenerate: a segment; rect with zero width
        box = np.array([hull[0], hull[1], hull[1], hull[0]])
        return order_clockwise_tl(box).astype(np.float32), 0.0

    edges = np.roll(hull, -1, axis=0) - hull
    angles = np.unique(np.mod(np.arctan2(edges[:, 1], edges[:, 0]), np.pi / 2.0))
    best_area = np.inf
    best = None
    for a in angles:
        c, s = np.cos(a), np.sin(a)
        rot = np.array([[c, s], [-s, c]])
        proj = hull @ rot.T
        mn, mx = proj.min(axis=0), proj.max(axis=0)
        area = (mx[0] - mn[0]) * (mx[1] - mn[1])
        if area < best_area:
            best_area = area
            corners = np.array(
                [[mn[0], mn[1]], [mx[0], mn[1]], [mx[0], mx[1]], [mn[0], mx[1]]]
            )
            best = corners @ rot  # rotate back
    assert best is not None
    box = order_clockwise_tl(best.astype(np.float32))
    side1 = float(np.linalg.norm(box[0] - box[1]))
    side2 = float(np.linalg.norm(box[3] - box[2]))
    return box, min(side1, side2)


def polygon_area(poly: np.ndarray) -> float:
    """Unsigned polygon area (shoelace) — ref: det_processor.rs:237 uses
    ``geo``'s unsigned_area."""
    p = np.asarray(poly, dtype=np.float64)
    x, y = p[:, 0], p[:, 1]
    return float(abs(np.dot(x, np.roll(y, -1)) - np.dot(y, np.roll(x, -1))) / 2.0)


def polygon_perimeter(poly: np.ndarray) -> float:
    """Closed-ring perimeter (ref: det_processor.rs:238-243)."""
    p = np.asarray(poly, dtype=np.float64)
    return float(np.linalg.norm(np.roll(p, -1, axis=0) - p, axis=1).sum())


def unclip(
    box: np.ndarray, unclip_ratio: float, arc_step_deg: float = 15.0
) -> np.ndarray:
    """Expand a convex polygon outward by ``distance = area * ratio / perimeter``
    with round joins — the Vatti/clipper offset of the reference
    (ref: det_processor.rs:223-252, distance formula at :244, round joins +
    integer scale 1.0 at :245-246).

    The reference (geo-clipper with scale factor 1.0) quantizes coordinates to
    integers; we do the same rounding on output for parity.  The caller
    re-runs ``min_area_rect`` on the result (det_processor.rs:306), so arc
    discretization density is not critical.
    """
    poly = np.asarray(box, dtype=np.float64).reshape(-1, 2)
    area = polygon_area(poly)
    perimeter = polygon_perimeter(poly)
    if perimeter <= 0:
        return poly.astype(np.float32)
    distance = area * float(unclip_ratio) / perimeter

    n = len(poly)
    # Ensure clockwise orientation in image coords (y down) == negative
    # shoelace signed area in the mathematical frame.
    x, y = poly[:, 0], poly[:, 1]
    signed = (np.dot(x, np.roll(y, -1)) - np.dot(y, np.roll(x, -1))) / 2.0
    if signed < 0:  # counter-clockwise in image coords (y down) -> flip
        poly = poly[::-1]

    out: list[np.ndarray] = []
    for i in range(n):
        prev_pt = poly[(i - 1) % n]
        cur = poly[i]
        nxt = poly[(i + 1) % n]
        # Outward normals of the two incident edges. For a clockwise polygon
        # in image coords (y down), the outward normal of edge (a -> b) is
        # (-(b-a).y, (b-a).x) normalized... derive: rotating the direction by
        # -90 deg in a y-down frame points away from the interior.
        def outward_normal(a: np.ndarray, b: np.ndarray) -> np.ndarray:
            d = b - a
            nrm = np.linalg.norm(d)
            if nrm == 0:
                return np.zeros(2)
            d = d / nrm
            return np.array([d[1], -d[0]])

        n_in = outward_normal(prev_pt, cur)
        n_out = outward_normal(cur, nxt)
        a0 = math.atan2(n_in[1], n_in[0])
        a1 = math.atan2(n_out[1], n_out[0])
        # sweep from a0 to a1 the short way (convex corner arc)
        sweep = (a1 - a0) % (2.0 * math.pi)
        if sweep > math.pi:  # reflex in this orientation; just use both ends
            out.append(cur + distance * n_in)
            out.append(cur + distance * n_out)
            continue
        steps = max(1, int(math.ceil(sweep / math.radians(arc_step_deg))))
        for k in range(steps + 1):
            ang = a0 + sweep * (k / steps)
            out.append(cur + distance * np.array([math.cos(ang), math.sin(ang)]))

    res = np.asarray(out)
    # Match clipper's integer quantization at scale factor 1.0
    return np.round(res).astype(np.float32)


def sort_boxes_reading_order(
    centers: np.ndarray, y_tol: float = 10.0
) -> np.ndarray:
    """Reading-order sort: top-to-bottom, then left-to-right for boxes whose
    center-y differ by less than ``y_tol`` (ref: det_processor.rs:324-333).

    Returns the permutation indices.  The reference feeds a 10-px-tolerance
    comparator straight into a stable merge sort; we reproduce the observable
    behavior with a stable y-sort followed by adjacent left-right swaps, which
    is well-defined for every input (the raw comparator is not transitive).
    """
    centers = np.asarray(centers, dtype=np.float32).reshape(-1, 2)
    n = len(centers)
    idx = sorted(range(n), key=lambda i: float(centers[i, 1]))
    # adjacent swap pass (PaddleOCR sorted_boxes semantics)
    for i in range(n - 1):
        for j in range(i, -1, -1):
            a, b = idx[j], idx[j + 1]
            if (
                abs(float(centers[b, 1]) - float(centers[a, 1])) < y_tol
                and float(centers[b, 0]) < float(centers[a, 0])
            ):
                idx[j], idx[j + 1] = idx[j + 1], idx[j]
            else:
                break
    return np.asarray(idx, dtype=np.int64)
