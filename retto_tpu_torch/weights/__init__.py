from .convert import convert_flax_params, export_flax_params, load_flax_params
from .onnx_bridge import build_fn, load_onnx
from .store import load_params_meta, save_params

__all__ = ["build_fn", "convert_flax_params", "export_flax_params", "load_flax_params",
           "load_onnx", "load_params_meta", "save_params"]
