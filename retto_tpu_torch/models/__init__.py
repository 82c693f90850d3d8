from .registry import MODEL_PRESETS, build_cls, build_det, build_rec

__all__ = ["MODEL_PRESETS", "build_det", "build_cls", "build_rec"]
