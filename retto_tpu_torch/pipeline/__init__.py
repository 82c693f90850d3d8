from .device_pipeline import DevicePipeline
from .engine import Engine, FakeEngine, TorchEngine
from .onnx_engine import OnnxEngine
from .session import RettoSession

__all__ = ["DevicePipeline", "Engine", "FakeEngine", "OnnxEngine", "RettoSession",
           "TorchEngine"]
