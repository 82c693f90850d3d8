"""The work a page needs, counted from shapes: FLOPs of the three models
and the bytes of the det epilogue, and the table of the cards' peaks.

FLOPs are those of the convolutions, dense layers and attention products
(two a multiply-add), counted by PyTorch's ``FlopCounterMode`` over the
reference models of ``reference.models`` run on shape-only ("meta")
tensors: det at the page's own det input size (before its bucket's
padding), cls at each crop's own width (twice: the crop and its 180-degree
turn, as the configuration's symmetrized cls runs), rec at each crop's own
width.  A zero count raises.
"""

from __future__ import annotations

import math
from functools import lru_cache
from pathlib import Path

import torch
from torch.utils.flop_counter import FlopCounterMode

from .reference.models import ClsRef, DetRef, Precision, RecRef, load_flat

__all__ = ["PEAKS", "peaks_of", "epilogue_bytes", "FlopCounter"]

# name as torch.cuda.get_device_name gives it -> (dense bf16 FLOP/s, HBM
# bytes/s): NVIDIA's data sheet for the H100 SXM, without sparsity
PEAKS: dict[str, tuple[float, float]] = {
    "NVIDIA H100 80GB HBM3": (989e12, 3.35e12),
}


def peaks_of(card: str) -> tuple[float, float]:
    if card not in PEAKS:
        raise KeyError(f"no peak figures for the card {card!r}")
    return PEAKS[card]


def epilogue_bytes(map_h: int, map_w: int, itemsize: int, pool: int) -> int:
    """Bytes one page's det epilogue must move: the [map_h, map_w] logit
    map read once, the row-packed mask [map_h / 8, map_w] and the pooled u8
    prob map [map_h / pool, map_w / pool] written once."""
    return map_h * map_w * itemsize + (map_h // 8) * map_w + (map_h // pool) * (map_w // pool)


def _count(fn, *args) -> float:
    counter = FlopCounterMode(display=False)
    with counter, torch.no_grad():
        fn(*args)
    flops = float(counter.get_total_flops())
    if flops <= 0:
        raise RuntimeError("the FLOP counter counted nothing")
    return flops


class FlopCounter:
    """FLOPs of one configuration (its file's dict ``cfg``; weight paths
    relative to ``root``)."""

    def __init__(self, cfg: dict, root: Path):
        meta = torch.device("meta")
        w, m = cfg["weights"], cfg["models"]
        prec = Precision("float32")
        self.det = DetRef(load_flat(root / w["det"], meta), prec, m["det"]["widths"],
                          m["det"]["depths"])
        self.cls = ClsRef(load_flat(root / w["cls"], meta), prec)
        self.rec = RecRef(load_flat(root / w["rec"], meta), prec, m["rec"]["dims"],
                          m["rec"]["depths"], m["rec"]["mixer_depth"], m["rec"]["num_heads"])
        s = cfg["session"]
        self.cls_h, self.cls_w = s["cls"]["image_shape"][1:]
        self.rec_h = s["rec"]["image_shape"][1]
        self.cls_views = 2 if s["cls"]["symmetrize"] else 1

    @lru_cache(maxsize=None)
    def det_flops(self, rh: int, rw: int) -> float:
        return _count(self.det, torch.empty((1, 3, rh, rw), device="meta"))

    @lru_cache(maxsize=None)
    def _cls_full(self) -> float:
        return _count(self.cls, torch.empty((1, 3, self.cls_h, self.cls_w), device="meta"))

    def cls_flops(self, width: int) -> float:
        """The cls of one crop of ``width`` columns (convs scale with it)."""
        return self.cls_views * self._cls_full() * width / self.cls_w

    @lru_cache(maxsize=None)
    def rec_flops(self, width: int) -> float:
        return _count(self.rec, torch.empty((1, 3, self.rec_h, max(width, 8)), device="meta"))

    def crop_widths(self, quad) -> tuple[int, int]:
        """(cls width, rec width) of a served box: its natural width at the
        crop height, the cls one capped at the cls input width."""
        import numpy as np

        q = np.asarray(quad, np.float64)
        w = max(int(max(np.hypot(*(q[1] - q[0])), np.hypot(*(q[2] - q[3])))), 1)
        h = max(int(max(np.hypot(*(q[2] - q[1])), np.hypot(*(q[3] - q[0])))), 1)
        if h / w >= 1.5:
            w, h = h, w
        return (min(self.cls_w, math.ceil(self.cls_h * w / h)),
                math.ceil(self.rec_h * w / h))
