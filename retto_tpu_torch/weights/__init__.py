from .convert import convert_flax_params, export_flax_params, load_flax_params
from .store import load_params_meta, save_params

__all__ = ["convert_flax_params", "export_flax_params", "load_flax_params",
           "load_params_meta", "save_params"]
