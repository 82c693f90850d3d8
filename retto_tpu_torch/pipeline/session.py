"""RettoSession — the public pipeline API of the port.

Port of ``retto_tpu/pipeline/session.py:37-283`` (the reference's session
layer, session.rs:58-143): decode -> clamp-resize -> det -> crop -> cls
(rotate) -> rec, with per-stage streaming callbacks, the ``run_many``
batch API with per-image error isolation, and the fused ``DevicePipeline``
over the same models.

    from retto_tpu_torch import RettoSession, SessionConfig
    session = RettoSession(SessionConfig(), charset=chars, weights={
        "det": "trained_weights/det.npz", "cls": ..., "rec": ...})
    result = session.run(open("page.png", "rb").read())      # staged
    session.run_stream(data, lambda ev: print(ev.stage))    # det, cls, rec
    results = session.device_pipeline().run_many(pages)     # fused
    session.close()  # or: with RettoSession(...) as session: ...

``device`` defaults to ``"cuda"`` and raises without a card; pass
``device="cpu"`` to run on the CPU.  ``mesh=`` (session.py:53-61, 102, 196)
hands a device mesh to the staged engine and to ``device_pipeline()``:
a ``parallel.mesh.Mesh`` that this process drives (each forward's batch,
each det chunk and each crop bucket split over its 'data' devices), or a
``torch.distributed`` ``DeviceMesh`` from ``parallel.distributed.
global_mesh()``, of which the session takes this rank's own card::

    from retto_tpu_torch.parallel import make_mesh
    session = RettoSession(cfg, mesh=make_mesh(), weights=...)  # every card
    results = session.device_pipeline().run_many(pages)
"""

from __future__ import annotations

import logging
import math
import threading
from typing import Any, Callable, Iterable, Sequence

import numpy as np
import torch

from ..config import SessionConfig
from ..errors import RettoConfigError, RettoEngineError, RettoError
from ..geometry import PointBox, scale_and_clip
from ..image.io import ImageHelper, decode_image
from ..models.common import cast_compute
from ..models.registry import build_cls, build_det, build_rec, torch_dtype
from ..parallel.mesh import mesh_devices
from ..ops.charset import CharacterDict, ascii_charset
from ..results import (
    ClsResult,
    DetBox,
    DetResult,
    OcrResult,
    RecResult,
    StageResult,
)
from ..utils.metrics import PipelineMetrics
from ..utils.timing import StageTimers
from ..weights import load_flax_params, load_params_meta
from .device_pipeline import DevicePipeline
from .engine import Engine, TorchEngine
from .stages import ClsStage, DetStage, RecStage

logger = logging.getLogger("retto_tpu_torch")

__all__ = ["RettoSession"]

RANDOM_INIT_SEED = 0


def _random_init(model: torch.nn.Module, gen: torch.Generator) -> None:
    """Overwrite every parameter from ``gen``: LeCun-normal kernels (Flax's
    default for Conv and Dense), zero biases, unit norm scales.  BatchNorm
    statistics keep their identity values."""
    with torch.no_grad():
        for name, p in model.named_parameters():
            if p.dim() >= 2:
                fan_in = math.prod(p.shape[1:])
                p.copy_(torch.randn(p.shape, generator=gen) / math.sqrt(fan_in))
            elif name.endswith("bias"):
                p.zero_()
            else:
                p.fill_(1.0)


class RettoSession:
    """Three-stage OCR session (session.rs:58-143).

    Construction options (session.py:37-70):
    * ``engine=`` — bring your own Engine (``FakeEngine`` for tests, a
      ``TorchEngine``, or an ``OnnxEngine`` over ``.onnx`` graphs);
    * ``weights={"det": path, "cls": path, "rec": path}`` — self-described
      ``.npz`` checkpoints, built into models that the staged engine and
      ``device_pipeline()`` share (one copy on the device, one lock);
    * neither — random weights drawn from a fixed-seed ``torch.Generator``
      (smoke/dev only; logged loudly);
    * ``mesh=`` — data parallelism over a device mesh (module docstring);
      the models are built on the mesh's first 'data' device, which is the
      session's ``device``.
    """

    def __init__(
        self,
        config: SessionConfig | None = None,
        engine: Engine | None = None,
        preset: str = "mobile",
        charset: CharacterDict | Sequence[str] | None = None,
        weights: dict[str, str] | None = None,
        device: str | torch.device | None = None,
        mesh=None,
    ):
        self.config = config or SessionConfig()
        self.device = mesh_devices(mesh, device)[0]
        self._mesh = mesh
        self.chars = self._resolve_charset(charset)
        self.metrics = PipelineMetrics()
        # set-up spans: ``load_weights`` (each checkpoint's load and its
        # Flax-layout conversion)
        self.timers = StageTimers()
        self._device_pipeline: DevicePipeline | None = None
        if engine is None:
            # one dispatch lock per session: the staged engine and the fused
            # pipeline drive the same models
            self.engine = TorchEngine(**self._build_models(preset, weights),
                                      device=self.device, lock=threading.RLock(), mesh=mesh)
        else:
            self.engine = engine
        cfg = self.config
        self._det = DetStage(cfg.det, cfg.buckets)
        self._cls = ClsStage(cfg.cls, cfg.buckets, cfg.mode, self.metrics)
        self._rec = RecStage(cfg.rec, cfg.buckets, cfg.mode, self.chars, self.metrics)

    def device_pipeline(self) -> DevicePipeline:
        """The fused device-resident fast path (pipeline.device_pipeline)
        over the engine's models: the session's own, a ``TorchEngine``'s or
        an ``OnnxEngine``'s translated graphs (session.py:72-107), under the
        engine's dispatch lock.  An engine without det, cls and rec models
        (a ``FakeEngine``) cannot be fused."""
        if self._device_pipeline is None:
            mods = self.engine.modules() if hasattr(self.engine, "modules") else {}
            if not all(k in mods for k in ("det", "cls", "rec")):
                raise RettoEngineError(
                    "device_pipeline requires fusable models: construct "
                    "RettoSession without engine=, or with a TorchEngine or "
                    "OnnxEngine holding det+cls+rec"
                )
            self._device_pipeline = DevicePipeline(
                mods["det"], mods["cls"], mods["rec"], self.config, self.chars,
                device=self.device, metrics=self.metrics,
                lock=getattr(self.engine, "lock", None), mesh=self._mesh,
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

    # ------------------------------------------------------------------ #
    def _resolve_charset(self, charset) -> CharacterDict:
        if isinstance(charset, CharacterDict):
            return charset
        if charset is not None:
            return CharacterDict(list(charset))
        rec_cfg = self.config.rec
        # session.rs:65-66: dict loaded at session init, ignored tokens [0]
        if rec_cfg.character_dict_path:
            return CharacterDict.from_file(rec_cfg.character_dict_path)
        if rec_cfg.characters:
            return CharacterDict(list(rec_cfg.characters))
        return CharacterDict(ascii_charset())

    def _build_models(self, preset: str, weights: dict[str, str] | None
                      ) -> dict[str, torch.nn.Module]:
        """det, cls and rec on the device in eval mode (session.py:121-170):
        a self-described checkpoint's ``__meta__`` arch kwargs replace the
        named preset's.  Module construction runs under a forked global RNG,
        so building a session never moves the caller's random state."""
        if weights and set(weights) != {"det", "cls", "rec"}:
            raise RettoConfigError(
                "retto_tpu_torch.RettoSession needs weights= with det, cls and rec "
                "checkpoints"
            )
        dtype_name = self.config.engine.compute_dtype
        builders = {"det": build_det, "cls": build_cls, "rec": build_rec}
        gen = None
        if not weights:
            logger.warning(
                "RettoSession: no weights given — using RANDOM weights "
                "(pipeline will run but recognize nothing; pass weights= "
                "or engine=)"
            )
            gen = torch.Generator().manual_seed(RANDOM_INIT_SEED)
        models: dict[str, torch.nn.Module] = {}
        for kind in ("det", "cls", "rec"):
            flat, kw = None, {}
            if weights:
                with self.timers.time("load_weights", kind=kind):
                    flat, meta = load_params_meta(weights[kind])
                kw = {
                    k: tuple(v) if isinstance(v, list) else v
                    for k, v in ((meta or {}).get("overrides") or {}).items()
                }
            # a self-described checkpoint REPLACES the preset kwargs
            p = "bare" if kw else preset
            if kind == "rec":
                kw.pop("num_classes", None)  # the charset governs the head
                kw["num_classes"] = self.chars.num_classes
            with torch.random.fork_rng(devices=[]):
                model = builders[kind](p, compute_dtype=dtype_name, **kw)
            if flat is not None:
                with self.timers.time("load_weights", kind=kind):
                    load_flax_params(model, flat)
            else:
                _random_init(model, gen)
            cast_compute(model, torch_dtype(dtype_name))
            models[kind] = model.to(self.device).eval()
        return {f"{k}_model": m for k, m in models.items()}

    # ------------------------------------------------------------------ #
    def _process_pipeline(
        self, data: bytes | np.ndarray, callback: Callable[[StageResult], None]
    ) -> None:
        """The forward pass (session.py:200-239; session.rs:75-106)."""
        m = self.metrics
        image = ImageHelper(decode_image(data))
        ori_h, ori_w = image.size()
        image.resize_both(self.config.max_side_len, self.config.min_side_len)
        after_h, after_w = image.size()

        with m.measure_stage("det"):
            boxes, scores = self._det(image, self.engine)
        m.crops += len(boxes)

        # crops are taken in the RESIZED image coords (session.rs:88-92);
        # the reported boxes are rescaled to original coords after
        # (session.rs:93-97)
        crops = [ImageHelper(image.get_crop_img(PointBox(b))) for b in boxes]
        boxes_ori = scale_and_clip(boxes, after_w, after_h, ori_w, ori_h)
        det_result = DetResult(
            [DetBox(PointBox(b), float(s)) for b, s in zip(boxes_ori, scores)]
        )
        callback(StageResult(stage="det", result=det_result))

        if self.config.use_cls:
            with m.measure_stage("cls"):
                labels = self._cls(crops, self.engine)
        else:
            labels = []
        callback(StageResult(stage="cls", result=ClsResult(labels)))

        with m.measure_stage("rec"):
            texts = self._rec(crops, self.engine)
        callback(StageResult(stage="rec", result=RecResult(texts)))

    # ------------------------------------------------------------------ #
    def run(self, data: bytes | np.ndarray) -> OcrResult:
        """One image -> full three-stage result (session.rs:108-131)."""
        slots: dict[str, Any] = {}

        def cb(stage: StageResult) -> None:
            logger.debug("%s result: %s", stage.stage, stage.result)
            slots[stage.stage] = stage.result

        with self.metrics.measure_image():
            self._process_pipeline(data, cb)
        return OcrResult(
            det_result=slots["det"],
            cls_result=slots["cls"],
            rec_result=slots["rec"],
        )

    def run_stream(
        self, data: bytes | np.ndarray, callback: Callable[[StageResult], None]
    ) -> None:
        """Stage-by-stage streaming: det, cls, rec events in that order
        (session.rs:133-143; the mpsc channel becomes a plain callback)."""
        self._process_pipeline(data, callback)

    def run_many(
        self,
        inputs: Iterable[bytes | np.ndarray],
        *,
        raise_on_error: bool = False,
    ) -> list[OcrResult | RettoError]:
        """Batch API with per-image error isolation: a bad decode yields the
        exception object in its slot instead of killing the batch
        (session.py:260-283)."""
        out: list[OcrResult | RettoError] = []
        for data in inputs:
            try:
                out.append(self.run(data))
            except RettoError as e:
                if raise_on_error:
                    raise
                logger.warning("run_many: image failed: %s", e)
                out.append(e)
        return out
