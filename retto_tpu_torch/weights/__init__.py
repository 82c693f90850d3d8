from .convert import convert_flax_params, load_flax_params
from .store import load_params_meta

__all__ = ["convert_flax_params", "load_flax_params", "load_params_meta"]
