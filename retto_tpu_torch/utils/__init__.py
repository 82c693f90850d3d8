from .metrics import PipelineMetrics

__all__ = ["PipelineMetrics"]
