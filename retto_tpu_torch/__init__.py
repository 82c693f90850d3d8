"""retto_tpu_torch: the PyTorch + CUDA port of retto_tpu for NVIDIA Hopper.

The OCR pipeline (DBNet det -> angle cls -> SVTR/CTC rec) in PyTorch, with
the det epilogue (binarize + dilate + bit-pack) as a CUDA kernel written
for sm_90a.  The JAX package ``retto_tpu`` stays the reference; this
package imports nothing of it.  Public API as ``retto_tpu/__init__.py:61-90``:

    from retto_tpu_torch import RettoSession, SessionConfig
    session = RettoSession(SessionConfig(), weights={...})  # device="cuda"
    result = session.run(image_bytes)                       # staged
    results = session.device_pipeline().run_many(images)    # fused
"""

__version__ = "0.1.0"

from .config import (
    BucketConfig,
    ClsConfig,
    DetConfig,
    EngineConfig,
    LimitType,
    PipelineMode,
    RecConfig,
    ScoreMode,
    SessionConfig,
)
from .errors import (
    ModelNotFoundError,
    RettoConfigError,
    RettoEngineError,
    RettoError,
    RettoImageError,
    RettoIOError,
    RettoShapeError,
    RettoWeightsError,
)
from .geometry import Point, PointBox
from .pipeline import (
    DevicePipeline,
    Engine,
    FakeEngine,
    OnnxEngine,
    RettoSession,
    TorchEngine,
)
from .results import (
    ClsLabel,
    ClsResult,
    DetBox,
    DetResult,
    OcrResult,
    RecResult,
    RecText,
    StageResult,
)

__all__ = [
    "RettoSession",
    "DevicePipeline",
    "Engine",
    "TorchEngine",
    "OnnxEngine",
    "FakeEngine",
    "SessionConfig",
    "DetConfig",
    "ClsConfig",
    "RecConfig",
    "BucketConfig",
    "EngineConfig",
    "LimitType",
    "ScoreMode",
    "PipelineMode",
    "Point",
    "PointBox",
    "DetBox",
    "DetResult",
    "ClsLabel",
    "ClsResult",
    "RecText",
    "RecResult",
    "OcrResult",
    "StageResult",
    "RettoError",
    "RettoIOError",
    "RettoImageError",
    "RettoShapeError",
    "RettoEngineError",
    "RettoWeightsError",
    "ModelNotFoundError",
    "RettoConfigError",
]
