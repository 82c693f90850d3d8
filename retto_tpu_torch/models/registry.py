"""Model presets and builders (PyTorch).

``MODEL_PRESETS`` is a copy of ``retto_tpu/models/registry.py:19-57``
(tests/test_torch_weights.py holds it equal to the JAX dict).  The builders
return modules with float32 parameters on the CPU, in inference mode, that
compute in ``compute_dtype``: ``pipeline.session`` loads a checkpoint into
them, casts them to the compute dtype and moves them to the device;
``train.trainer`` trains them as they are.
"""

from __future__ import annotations

from typing import Any

import torch

from .dbnet import DetModel
from .mobilenetv3 import ClsModel
from .svtr import RecModel

__all__ = ["MODEL_PRESETS", "build_det", "build_cls", "build_rec", "torch_dtype"]

MODEL_PRESETS: dict[str, dict[str, dict[str, Any]]] = {
    "tiny": {
        "det": dict(widths=(32, 48, 64, 96), depths=(1, 1, 1, 1),
                    inner_ch=64, head_ch=32),
        "cls": dict(scale=0.2),
        "rec": dict(dims=(32, 64, 96, 128), depths=(1, 1, 1, 1),
                    mixer_dim=64, mixer_depth=1, num_heads=4),
    },
    "mobile": {
        "det": dict(backbone="tpu_v2", widths=(128, 256, 384),
                    depths=(2, 2, 2), inner_ch=128, head_ch=128),
        "cls": dict(arch="dense", width=128),
        "rec": dict(dims=(64, 128, 256, 512), depths=(2, 2, 2, 2),
                    mixer_dim=120, mixer_depth=2, num_heads=8),
    },
    "server": {
        "det": dict(backbone="tpu_v2", widths=(256, 384, 512),
                    depths=(1, 2, 2), inner_ch=256, head_ch=256),
        "cls": dict(arch="dense", width=128),
        "rec": dict(dims=(96, 192, 384, 768), depths=(3, 3, 6, 3),
                    mixer_dim=256, mixer_depth=4, num_heads=8),
    },
    "bare": {"det": {}, "cls": {}, "rec": {}},
}


def torch_dtype(name: str | None) -> torch.dtype | None:
    """The checkpoint's ``compute_dtype`` name -> torch dtype (None = f32)."""
    if name in (None, "float32", "f32"):
        return None
    return getattr(torch, name)


def build_det(preset: str = "mobile", compute_dtype: str | None = "bfloat16",
              **overrides: Any) -> DetModel:
    kw = dict(MODEL_PRESETS[preset]["det"])
    kw.update(overrides)
    return DetModel(dtype=torch_dtype(compute_dtype), **kw)


def build_cls(preset: str = "mobile", num_classes: int = 2,
              compute_dtype: str | None = "bfloat16", **overrides: Any) -> ClsModel:
    kw = dict(MODEL_PRESETS[preset]["cls"])
    kw.update(overrides)
    return ClsModel(num_classes=num_classes,
                    dtype=torch_dtype(compute_dtype), **kw)


def build_rec(preset: str = "mobile", num_classes: int = 6625,
              compute_dtype: str | None = "bfloat16", **overrides: Any) -> RecModel:
    kw = dict(MODEL_PRESETS[preset]["rec"])
    kw.update(overrides)
    return RecModel(num_classes=num_classes,
                    dtype=torch_dtype(compute_dtype), **kw)
