from .device_pipeline import DevicePipeline
from .engine import Engine, FakeEngine, TorchEngine
from .session import RettoSession

__all__ = ["DevicePipeline", "Engine", "FakeEngine", "RettoSession", "TorchEngine"]
