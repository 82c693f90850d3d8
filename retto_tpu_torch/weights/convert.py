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

``export_flax_params`` is the inverse: a port module's state as Flax's flat
``::`` names and layouts, which ``weights.store.save_params`` writes and
the JAX package's ``load_params_meta`` reads.
"""

from __future__ import annotations

from typing import Mapping

import numpy as np
import torch
from torch import nn

from .store import SEP

__all__ = ["convert_flax_params", "export_flax_params", "load_flax_params"]

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
    every missing and every unused key (there must be none of either, but
    for the prefixes in the module's ``optional_state``)."""
    sd = convert_flax_params(flat)
    missing, unused = module.load_state_dict(sd, strict=False)
    # state a checkpoint may lack (DetModel's train-time threshold head,
    # absent from a Flax model initialised for inference)
    optional = getattr(module, "optional_state", ())
    missing = [k for k in missing if not k.startswith(optional)] if optional else missing
    if missing or unused:
        raise KeyError(
            f"{type(module).__name__}: missing keys {sorted(missing)}, "
            f"unused keys {sorted(unused)}"
        )
    return module


def export_flax_params(module: nn.Module) -> dict[str, np.ndarray]:
    """``module``'s parameters and running statistics as flat ``::``-keyed
    Flax variables (float32): the inverse of :func:`convert_flax_params`."""
    from ..models.common import BatchNorm, Conv, Dense, LayerNorm
    from ..models.svtr import MultiHeadDotProductAttention

    out: dict[str, np.ndarray] = {}

    def put(col: str, path: str, leaf: str, t: torch.Tensor) -> None:
        out[SEP.join([col, *path.split("."), leaf])] = t.detach().float().cpu().numpy()

    for path, m in module.named_modules():
        if isinstance(m, Conv):  # OIHW -> HWIO
            put("params", path, "kernel", m.weight.permute(2, 3, 1, 0))
        elif isinstance(m, Dense) and not path.endswith("out_proj"):
            put("params", path, "kernel", m.weight.t())
        elif isinstance(m, (BatchNorm, LayerNorm)):
            put("params", path, "scale", m.weight)
            if isinstance(m, BatchNorm):
                put("batch_stats", path, "mean", m.running_mean)
                put("batch_stats", path, "var", m.running_var)
        elif isinstance(m, MultiHeadDotProductAttention):
            d, h = m.in_proj_weight.shape[1], m.num_heads
            for i, name in enumerate(_QKV):
                w = m.in_proj_weight[i * d:(i + 1) * d]
                put("params", f"{path}.{name}", "kernel", w.t().reshape(d, h, d // h))
                put("params", f"{path}.{name}", "bias",
                    m.in_proj_bias[i * d:(i + 1) * d].reshape(h, d // h))
            put("params", f"{path}.out", "kernel", m.out_proj.weight.t().reshape(h, d // h, d))
            put("params", f"{path}.out", "bias", m.out_proj.bias)
            continue
        else:
            continue
        if getattr(m, "bias", None) is not None:
            put("params", path, "bias", m.bias)
    return out
