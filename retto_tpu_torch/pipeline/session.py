"""RettoSession, slim: the normal entry point of the port.

Port of the fused-path half of ``retto_tpu/pipeline/session.py``: build
det, cls and rec from self-described checkpoints (the ``__meta__``
arch kwargs win over the named preset, session.py:121-170), resolve the
charset, and hand out the fused ``DevicePipeline`` (README.md:13-22).
The staged COMPAT ``run``/``run_stream`` path is not ported yet.

    from retto_tpu_torch import RettoSession, SessionConfig
    session = RettoSession(SessionConfig(), charset=chars, weights={
        "det": "trained_weights/det.npz", "cls": ..., "rec": ...})
    results = session.device_pipeline().run_many(pages)
    session.close()  # or: with RettoSession(...) as session: ...
"""

from __future__ import annotations

from typing import Any, Sequence

import torch

from ..config import SessionConfig
from ..device import resolve_device
from ..errors import RettoConfigError
from ..models.common import cast_compute
from ..models.registry import build_cls, build_det, build_rec, torch_dtype
from ..ops.charset import CharacterDict, ascii_charset
from ..utils.metrics import PipelineMetrics
from ..weights import load_flax_params, load_params_meta
from .device_pipeline import DevicePipeline

__all__ = ["RettoSession"]


class RettoSession:
    """``weights={"det": path, "cls": path, "rec": path}`` names the three
    ``.npz`` checkpoints; ``device`` defaults to ``"cuda"`` and raises when
    there is no card (pass ``device="cpu"`` to run on the CPU)."""

    def __init__(
        self,
        config: SessionConfig | None = None,
        preset: str = "mobile",
        charset: CharacterDict | Sequence[str] | None = None,
        weights: dict[str, str] | None = None,
        device: str | torch.device = "cuda",
    ):
        self.config = config or SessionConfig()
        self.device = resolve_device(device)
        self.chars = self._resolve_charset(charset)
        self.metrics = PipelineMetrics()
        if not weights or set(weights) != {"det", "cls", "rec"}:
            raise RettoConfigError(
                "retto_tpu_torch.RettoSession needs weights= with det, cls and rec "
                "checkpoints"
            )
        self.models = self._build_models(preset, weights)
        self._device_pipeline: DevicePipeline | None = None

    def device_pipeline(self) -> DevicePipeline:
        """The fused device-resident fast path (pipeline.device_pipeline)."""
        if self._device_pipeline is None:
            self._device_pipeline = DevicePipeline(
                self.models["det"], self.models["cls"], self.models["rec"],
                self.config, self.chars, device=self.device, metrics=self.metrics,
            )
        return self._device_pipeline

    def close(self) -> None:
        """Release the fused pipeline's host threads (session.py:107-113).
        Idempotent; safe when no device pipeline was ever built."""
        if self._device_pipeline is not None:
            self._device_pipeline.close()
            self._device_pipeline = None

    def __enter__(self) -> "RettoSession":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def _resolve_charset(self, charset) -> CharacterDict:
        if isinstance(charset, CharacterDict):
            return charset
        if charset is not None:
            return CharacterDict(list(charset))
        rec_cfg = self.config.rec
        if rec_cfg.character_dict_path:
            return CharacterDict.from_file(rec_cfg.character_dict_path)
        if rec_cfg.characters:
            return CharacterDict(list(rec_cfg.characters))
        return CharacterDict(ascii_charset())

    def _build_models(self, preset: str, weights: dict[str, str]) -> dict[str, Any]:
        dtype_name = self.config.engine.compute_dtype
        builders = {"det": build_det, "cls": build_cls, "rec": build_rec}
        models: dict[str, Any] = {}
        for kind, path in weights.items():
            flat, meta = load_params_meta(path)
            kw = {
                k: tuple(v) if isinstance(v, list) else v
                for k, v in ((meta or {}).get("overrides") or {}).items()
            }
            # a self-described checkpoint REPLACES the preset kwargs
            p = "bare" if kw else preset
            if kind == "rec":
                kw.pop("num_classes", None)  # the charset governs the head
                kw["num_classes"] = self.chars.num_classes
            model = builders[kind](p, compute_dtype=dtype_name, **kw)
            load_flax_params(model, flat)
            cast_compute(model, torch_dtype(dtype_name))
            models[kind] = model.to(self.device).eval()
        return models
