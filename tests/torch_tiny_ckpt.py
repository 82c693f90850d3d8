"""Tiny self-described checkpoints shared by the port's tests: a small
tpu_v2 det, a dense cls and the tiny SVTR rec, random weights from Flax's
init (seeded), saved with ``retto_tpu.weights.save_params`` so that both
packages load the same files.  ``configs`` gives the permissive det
thresholds that make the random det fire, so crops reach cls and rec."""

from __future__ import annotations

from pathlib import Path

import jax
import jax.numpy as jnp

from retto_tpu.models import MODEL_PRESETS, build_cls, build_det, build_rec
from retto_tpu.ops.charset import ascii_charset
from retto_tpu.weights import save_params

ARCH = {
    "det": dict(backbone="tpu_v2", widths=[32, 64, 96], depths=[1, 1, 1], inner_ch=32,
                head_ch=32),
    "cls": dict(arch="dense", width=16),
    "rec": {k: list(v) if isinstance(v, tuple) else v
            for k, v in MODEL_PRESETS["tiny"]["rec"].items()},
}


def write_tiny_checkpoints(d: Path) -> dict[str, str]:
    """det/cls/rec ``.npz`` files under ``d``; returns their paths."""
    n_cls = len(ascii_charset()) + 2
    tup = {k: {kk: tuple(vv) if isinstance(vv, list) else vv for kk, vv in v.items()}
           for k, v in ARCH.items()}
    models = {
        "det": build_det("bare", compute_dtype="float32", **tup["det"]),
        "cls": build_cls("bare", compute_dtype="float32", **tup["cls"]),
        "rec": build_rec("bare", num_classes=n_cls, compute_dtype="float32", **tup["rec"]),
    }
    shapes = {"det": (1, 3, 64, 64), "cls": (1, 3, 48, 192), "rec": (1, 3, 48, 320)}
    paths = {}
    for i, (k, m) in enumerate(models.items()):
        x = jnp.zeros(shapes[k])
        # det: init in train mode so the threshold head (a trained
        # checkpoint carries it) exists too
        kw = {"train": True} if k == "det" else {}
        variables = jax.jit(lambda r, v, m=m, kw=kw: m.init(r, v, **kw))(
            jax.random.PRNGKey(i), x)
        paths[k] = str(d / f"{k}.npz")
        save_params(paths[k], variables, meta={"preset": "bare", "overrides": ARCH[k]})
    return paths


def configs(cls_cfg, bucket_cls, transfer: str = "yuv420"):
    """A float32 session config of either package for the tiny checkpoints."""
    cfg = cls_cfg()
    cfg.det.limit_side_len = 128
    cfg.det.thresh = 0.45
    cfg.det.box_thresh = 0.1
    cfg.det.max_candidates = 8
    cfg.buckets = bucket_cls(det_pad_to=64, det_max_side=256, rec_width_buckets=(320,),
                             cls_batch_buckets=(4,), rec_batch_buckets=(4,))
    cfg.engine.compute_dtype = "float32"
    cfg.engine.transfer_format = transfer
    return cfg
