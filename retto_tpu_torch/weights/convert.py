"""Flax variables -> PyTorch state dict.

The port's modules carry the Flax scope names as attribute names
(``models/common.py``), so a checkpoint key maps onto a state-dict key by
dropping the collection and renaming the leaf:

=====================================  =====================================
Flax (``collection::path::leaf``)      PyTorch (``path.leaf``)
=====================================  =====================================
conv ``kernel`` HWIO                   ``weight`` OIHW
depthwise ``kernel`` [kh, kw, 1, C]    ``weight`` [C, 1, kh, kw] (same rule)
Dense ``kernel`` [in, out]             ``weight`` [out, in]
MHA ``query|key|value::kernel``        ``in_proj_weight`` [3D, D]
[D, H, Dh] and ``::bias`` [H, Dh]      and ``in_proj_bias`` [3D]
MHA ``out::kernel`` [H, Dh, D]         ``out_proj.weight`` [D, H*Dh]
BN/LN ``scale`` / ``bias``             ``weight`` / ``bias``
``batch_stats`` ``mean`` / ``var``     ``running_mean`` / ``running_var``
=====================================  =====================================

Converted weights live in memory only; nothing is written to disk.
"""

from __future__ import annotations

from typing import Mapping

import numpy as np
import torch
from torch import nn

from .store import SEP

__all__ = ["convert_flax_params", "load_flax_params"]

_QKV = ("query", "key", "value")


def convert_flax_params(flat: Mapping[str, np.ndarray]) -> dict[str, torch.Tensor]:
    """Flat ``::``-keyed Flax variables -> state dict (float32 tensors)."""
    out: dict[str, np.ndarray] = {}
    mha: dict[str, dict[str, np.ndarray]] = {}
    for key, arr in flat.items():
        col, *path, leaf = key.split(SEP)
        arr = np.asarray(arr, np.float32)
        if col == "batch_stats":
            name = {"mean": "running_mean", "var": "running_var"}[leaf]
            out[".".join([*path, name])] = arr
            continue
        if col != "params":
            raise KeyError(f"unknown variable collection in {key!r}")
        if path and path[-1] in (*_QKV, "out") and "MultiHeadDotProductAttention" in path[-2]:
            mha.setdefault(".".join(path[:-1]), {})[f"{path[-1]}.{leaf}"] = arr
            continue
        def at(name: str) -> str:
            return ".".join([*path, name])

        if leaf == "kernel":
            if arr.ndim == 4:  # HWIO (dense or depthwise) -> OIHW
                arr = arr.transpose(3, 2, 0, 1)
            elif arr.ndim == 2:  # Dense [in, out] -> [out, in]
                arr = arr.T
            else:
                raise ValueError(f"unexpected kernel rank {arr.ndim} at {key!r}")
            out[at("weight")] = arr
        elif leaf == "scale":
            out[at("weight")] = arr
        elif leaf == "bias":
            out[at("bias")] = arr
        else:
            raise KeyError(f"unknown parameter leaf in {key!r}")
    for prefix, p in mha.items():
        d = p["query.kernel"].shape[0]
        out[f"{prefix}.in_proj_weight"] = np.concatenate(
            [p[f"{n}.kernel"].reshape(d, -1).T for n in _QKV]
        )
        out[f"{prefix}.in_proj_bias"] = np.concatenate(
            [p[f"{n}.bias"].reshape(-1) for n in _QKV]
        )
        ok = p["out.kernel"]
        out[f"{prefix}.out_proj.weight"] = ok.reshape(-1, ok.shape[-1]).T
        out[f"{prefix}.out_proj.bias"] = p["out.bias"]
    return {k: torch.from_numpy(np.array(v, np.float32)) for k, v in out.items()}


def load_flax_params(module: nn.Module, flat: Mapping[str, np.ndarray]) -> nn.Module:
    """Load a Flax checkpoint into ``module``; raises ``KeyError`` naming
    every missing and every unused key (there must be none of either)."""
    sd = convert_flax_params(flat)
    missing, unused = module.load_state_dict(sd, strict=False)
    if missing or unused:
        raise KeyError(
            f"{type(module).__name__}: missing keys {sorted(missing)}, "
            f"unused keys {sorted(unused)}"
        )
    return module
