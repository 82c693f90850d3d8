"""retto_tpu_torch: the PyTorch + CUDA port of retto_tpu for NVIDIA Hopper.

The fused OCR pipeline (DBNet det -> angle cls -> SVTR/CTC rec) in
PyTorch, with the det epilogue (binarize + dilate + bit-pack) as a CUDA
kernel written for sm_90a.  The JAX package ``retto_tpu`` stays the
reference; this package imports nothing of it.

    from retto_tpu_torch import RettoSession, SessionConfig
    session = RettoSession(SessionConfig(), weights={...})  # device="cuda"
    results = session.device_pipeline().run_many(images)
"""

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
from .errors import RettoError
from .pipeline import DevicePipeline, RettoSession
from .results import OcrResult

__all__ = [
    "BucketConfig",
    "ClsConfig",
    "DetConfig",
    "DevicePipeline",
    "EngineConfig",
    "LimitType",
    "OcrResult",
    "PipelineMode",
    "RecConfig",
    "RettoError",
    "RettoSession",
    "ScoreMode",
    "SessionConfig",
]
