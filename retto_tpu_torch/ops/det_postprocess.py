"""Full DB detection postprocess (host assembly).

Port copy of ``retto_tpu/ops/det_postprocess.py``: the port imports nothing of the JAX
package, so it keeps its own copy of this host-only module.

Implements the reference's postprocess chain (det_processor.rs:279-335):

    mask -> contours -> min-area rect (sside filter >= min_mini_box_size)
         -> box_score_fast vs box_thresh
         -> unclip (area*ratio/perimeter, round joins)
         -> re-min-rect (sside filter >= min_mini_box_size + 2)
         -> scale_and_clip to the pre-det image
         -> drop boxes with h/w <= 3 px
         -> reading-order sort (10-px row tolerance)

The device half (threshold + dilation) lives in retto_tpu.ops.db_post; this
function takes the probability map and the already-binarized mask as NumPy
arrays.
"""

from __future__ import annotations

import numpy as np

from ..config import DetConfig, ScoreMode
from ..geometry import (
    min_area_rect,
    scale_and_clip,
    sort_boxes_reading_order,
    unclip,
)
from .contours import find_contour_point_sets
from .raster import box_score_fast, box_score_slow

__all__ = ["det_postprocess", "det_candidates", "det_finalize"]


def det_candidates(mask: np.ndarray, cfg: DetConfig) -> np.ndarray:
    """First half of the postprocess, no probability map needed: contours ->
    integer min-area rects -> sside filter.  Returns candidate quads
    [M, 4, 2] float32.  Used by the device pipeline, which scores the
    candidates ON DEVICE (resampled mean) instead of downloading the prob
    map (PERFORMANCE-mode deviation; compat path uses det_postprocess)."""
    from ..native import det_candidates_native

    out = det_candidates_native(mask, cfg.min_mini_box_size, cfg.max_candidates)
    if out is not None:
        return out
    boxes = []
    for contour in find_contour_point_sets(mask, cfg.max_candidates):
        box, _ = min_area_rect(contour)
        box = np.round(box).astype(np.float64)
        side1 = float(np.linalg.norm(box[0] - box[1]))
        side2 = float(np.linalg.norm(box[3] - box[2]))
        if min(side1, side2) < cfg.min_mini_box_size:
            continue
        boxes.append(box)
    if not boxes:
        return np.zeros((0, 4, 2), np.float32)
    return np.stack(boxes).astype(np.float32)


def det_finalize(
    cand_boxes: np.ndarray,
    cand_scores: np.ndarray,
    cfg: DetConfig,
    bitmap_h: int,
    bitmap_w: int,
    dest_h: int,
    dest_w: int,
) -> tuple[np.ndarray, np.ndarray]:
    """Second half: score filter -> unclip -> re-rect -> rescale -> size
    filter -> reading-order sort.  Mirrors det_postprocess after scoring."""
    from ..native import det_finalize_native

    if len(cand_boxes):
        out = det_finalize_native(
            cand_boxes, cand_scores, cfg.box_thresh, cfg.unclip_ratio,
            cfg.min_mini_box_size, bitmap_h, bitmap_w, dest_h, dest_w,
        )
        if out is not None:
            return out
    boxes: list[np.ndarray] = []
    scores: list[float] = []
    for box, score in zip(np.asarray(cand_boxes, np.float64), cand_scores):
        if score < cfg.box_thresh:
            continue
        expanded = unclip(box, cfg.unclip_ratio)
        box2, sside2 = min_area_rect(expanded)
        if sside2 < cfg.min_mini_box_size + 2:
            continue
        box3 = scale_and_clip(box2[None], bitmap_w, bitmap_h, dest_w, dest_h)[0]
        bh = float(np.linalg.norm(box3[0] - box3[3]))
        bw = float(np.linalg.norm(box3[0] - box3[1]))
        if bh <= 3.0 or bw <= 3.0:
            continue
        boxes.append(box3)
        scores.append(float(score))
    if not boxes:
        return (
            np.zeros((0, 4, 2), dtype=np.float32),
            np.zeros((0,), dtype=np.float32),
        )
    boxes_arr = np.stack(boxes).astype(np.float32)
    scores_arr = np.asarray(scores, dtype=np.float32)
    centers = (boxes_arr[:, 0] + boxes_arr[:, 2]) / 2.0
    order = sort_boxes_reading_order(centers, y_tol=10.0)
    return boxes_arr[order], scores_arr[order]


def det_postprocess(
    pred: np.ndarray,
    mask: np.ndarray,
    cfg: DetConfig,
    dest_h: int,
    dest_w: int,
    backend: str = "auto",
) -> tuple[np.ndarray, np.ndarray]:
    """pred: [H, W] float32 probability map (det model output, same size as
    the det input image); mask: [H, W] binarized/dilated map; dest_h/dest_w:
    the pre-det-resize image size the boxes are rescaled to
    (det_processor.rs postprocess is constructed with the session's
    post-resize_both size — session.rs:85).

    Returns (boxes [N, 4, 2] float32 in dest coords, scores [N] float32),
    sorted in reading order.

    ``backend``: "auto" uses the fused C++ implementation when a compiler
    is available (retto_tpu.native — the slot the reference fills with
    clipper-sys C++), "numpy" forces the Python path, "native" requires C++.
    """
    # SLOW scores over the original contour polygon (PaddleOCR semantics
    # for the mode the reference declares but never implements,
    # det_processor.rs:20-29) — host-path only: the C++ pass and the
    # device pipeline's pooled scoring implement FAST
    slow = cfg.score_mode == ScoreMode.SLOW
    if slow and backend == "native":
        raise RuntimeError(
            "ScoreMode.SLOW is host-path only (the C++ pass scores FAST); "
            "use backend='auto' or 'numpy'"
        )
    if backend != "numpy" and not slow:
        from ..native import det_postprocess_native

        out = det_postprocess_native(
            pred, mask, cfg.box_thresh, cfg.unclip_ratio,
            cfg.min_mini_box_size, cfg.max_candidates, dest_h, dest_w,
        )
        if out is not None:
            return out
        if backend == "native":
            raise RuntimeError("native postprocess backend unavailable")

    h, w = pred.shape
    boxes: list[np.ndarray] = []
    scores: list[float] = []
    for contour in find_contour_point_sets(mask, cfg.max_candidates):
        box, _ = min_area_rect(contour)
        # the reference's first mini box is integer-typed (contours are i32,
        # imageproc returns Point<i32>); quantize before filtering/scoring
        box = np.round(box).astype(np.float64)
        side1 = float(np.linalg.norm(box[0] - box[1]))
        side2 = float(np.linalg.norm(box[3] - box[2]))
        sside = min(side1, side2)
        if sside < cfg.min_mini_box_size:
            continue
        score = (
            box_score_slow(pred, contour) if slow else box_score_fast(pred, box)
        )
        if score < cfg.box_thresh:
            continue
        expanded = unclip(box, cfg.unclip_ratio)
        box2, sside2 = min_area_rect(expanded)
        if sside2 < cfg.min_mini_box_size + 2:
            continue
        box3 = scale_and_clip(box2[None], w, h, dest_w, dest_h)[0]
        bh = float(np.linalg.norm(box3[0] - box3[3]))
        bw = float(np.linalg.norm(box3[0] - box3[1]))
        if bh <= 3.0 or bw <= 3.0:
            continue
        boxes.append(box3)
        scores.append(score)

    if not boxes:
        return (
            np.zeros((0, 4, 2), dtype=np.float32),
            np.zeros((0,), dtype=np.float32),
        )
    boxes_arr = np.stack(boxes).astype(np.float32)
    scores_arr = np.asarray(scores, dtype=np.float32)
    centers = (boxes_arr[:, 0] + boxes_arr[:, 2]) / 2.0
    order = sort_boxes_reading_order(centers, y_tol=10.0)
    return boxes_arr[order], scores_arr[order]
