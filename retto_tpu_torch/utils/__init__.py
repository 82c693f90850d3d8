from .metrics import PipelineMetrics
from .timing import StageTimers, device_fetch_sync, time_fn

__all__ = ["PipelineMetrics", "StageTimers", "device_fetch_sync", "time_fn"]
