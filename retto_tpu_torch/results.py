"""Result types for the three pipeline stages.

Port copy of ``retto_tpu/results.py``: the port imports nothing of the JAX
package, so it keeps its own copy of this host-only module.

Mirrors the reference's serde-serializable result structs so a reference
user finds the same wire shapes (documented in the TS wrapper,
retto-wasm/fe/index.ts:5-42):

* ``DetResult``   — DetProcessorResult / DetProcessorInnerResult
                    (det_processor.rs:104-113): per-box quad + score
* ``ClsResult``   — ClsProcessorResult / ClsPostProcessLabel
                    (cls_processor.rs:43-66): per-crop {label, score}
* ``RecResult``   — RecProcessorResult / RecProcessorSingleResult
                    (rec_processor.rs:157-165): per-crop {text, score}
* ``OcrResult``   — RettoWorkerResult (session.rs:42-48)
* ``StageResult`` — RettoWorkerStageResult (session.rs:50-56)
"""

from __future__ import annotations

import json
from dataclasses import dataclass, field
from typing import Any, Iterator, Literal

import numpy as np

from .geometry import PointBox

__all__ = [
    "DetBox",
    "DetResult",
    "ClsLabel",
    "ClsResult",
    "RecText",
    "RecResult",
    "OcrResult",
    "StageResult",
]


@dataclass
class DetBox:
    """One detected text region (det_processor.rs:104-109)."""

    box: PointBox
    score: float

    def to_dict(self) -> dict[str, Any]:
        # Wire shape matches the serde output consumed by the TS wrapper:
        # boxes = {"inner": [{x, y} * 4]} (fe/index.ts:10-16). We flatten to
        # a list of {x, y} while keeping the clockwise-from-TL order.
        return {
            "boxes": [
                {"x": float(x), "y": float(y)} for x, y in self.box.pts.tolist()
            ],
            "score": float(self.score),
        }


@dataclass
class DetResult:
    """All detected regions of one image, reading order
    (det_processor.rs:111-113, ordering at :324-333)."""

    boxes: list[DetBox] = field(default_factory=list)

    def __len__(self) -> int:
        return len(self.boxes)

    def __iter__(self) -> Iterator[DetBox]:
        return iter(self.boxes)

    def __getitem__(self, i: int) -> DetBox:
        return self.boxes[i]

    def as_array(self) -> np.ndarray:
        """(N, 4, 2) float32 quads."""
        if not self.boxes:
            return np.zeros((0, 4, 2), dtype=np.float32)
        return np.stack([b.box.pts for b in self.boxes])

    def to_dict(self) -> list[dict[str, Any]]:
        return [b.to_dict() for b in self.boxes]


@dataclass
class ClsLabel:
    """Angle prediction for one crop (cls_processor.rs:43-47)."""

    label: int = 0  # degrees: 0 or 180
    score: float = 0.0

    def to_dict(self) -> dict[str, Any]:
        return {"label": int(self.label), "score": float(self.score)}


@dataclass
class ClsResult:
    """Per-crop angle labels in detection order (cls_processor.rs:64-66)."""

    labels: list[ClsLabel] = field(default_factory=list)

    def __len__(self) -> int:
        return len(self.labels)

    def __iter__(self) -> Iterator[ClsLabel]:
        return iter(self.labels)

    def __getitem__(self, i: int) -> ClsLabel:
        return self.labels[i]

    def to_dict(self) -> list[dict[str, Any]]:
        return [{"label": l.to_dict()} for l in self.labels]


@dataclass
class RecText:
    """Recognized text for one crop (rec_processor.rs:157-161)."""

    text: str = ""
    score: float = 0.0

    def to_dict(self) -> dict[str, Any]:
        return {"text": self.text, "score": float(self.score)}


@dataclass
class RecResult:
    """Per-crop texts in detection order (rec_processor.rs:163-165)."""

    texts: list[RecText] = field(default_factory=list)

    def __len__(self) -> int:
        return len(self.texts)

    def __iter__(self) -> Iterator[RecText]:
        return iter(self.texts)

    def __getitem__(self, i: int) -> RecText:
        return self.texts[i]

    def to_dict(self) -> list[dict[str, Any]]:
        return [t.to_dict() for t in self.texts]


@dataclass
class OcrResult:
    """Aggregated three-stage result (session.rs:42-48)."""

    det_result: DetResult
    cls_result: ClsResult
    rec_result: RecResult

    def to_dict(self) -> dict[str, Any]:
        return {
            "det_result": self.det_result.to_dict(),
            "cls_result": self.cls_result.to_dict(),
            "rec_result": self.rec_result.to_dict(),
        }

    def to_json(self, **kw: Any) -> str:
        return json.dumps(self.to_dict(), ensure_ascii=False, **kw)

    def lines(self) -> list[tuple[str, float]]:
        """Convenience: [(text, score)] in reading order."""
        return [(t.text, t.score) for t in self.rec_result]


@dataclass
class StageResult:
    """One streamed stage event (session.rs:50-56): stage in
    {"det", "cls", "rec"} — matches the wasm/TS streaming contract
    (fe/index.ts:44-56)."""

    stage: Literal["det", "cls", "rec"]
    result: DetResult | ClsResult | RecResult

    def to_dict(self) -> dict[str, Any]:
        return {"stage": self.stage, "result": self.result.to_dict()}
