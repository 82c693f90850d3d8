from .device_pipeline import DevicePipeline
from .session import RettoSession

__all__ = ["DevicePipeline", "RettoSession"]
