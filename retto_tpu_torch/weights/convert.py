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

__all__ = ["convert_flax_params", "export_flax_params", "flax_param_paths",
           "load_flax_params"]

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


def _flax_leaves(module: nn.Module):
    """(flat Flax key, state-dict name, tensor in Flax's layout) of each of
    ``module``'s parameters and running statistics."""
    from ..models.common import BatchNorm, Conv, Dense, LayerNorm
    from ..models.svtr import MultiHeadDotProductAttention

    def key(col: str, path: str, leaf: str) -> str:
        return SEP.join([col, *path.split("."), leaf])

    def at(path: str, name: str) -> str:
        return f"{path}.{name}" if path else name

    for path, m in module.named_modules():
        if isinstance(m, Conv):  # OIHW -> HWIO
            yield key("params", path, "kernel"), at(path, "weight"), m.weight.permute(2, 3, 1, 0)
        elif isinstance(m, Dense) and not path.endswith("out_proj"):
            yield key("params", path, "kernel"), at(path, "weight"), m.weight.t()
        elif isinstance(m, (BatchNorm, LayerNorm)):
            yield key("params", path, "scale"), at(path, "weight"), m.weight
            if isinstance(m, BatchNorm):
                yield key("batch_stats", path, "mean"), at(path, "running_mean"), m.running_mean
                yield key("batch_stats", path, "var"), at(path, "running_var"), m.running_var
        elif isinstance(m, MultiHeadDotProductAttention):
            d, h = m.in_proj_weight.shape[1], m.num_heads
            for i, name in enumerate(_QKV):
                w = m.in_proj_weight[i * d:(i + 1) * d]
                yield (key("params", f"{path}.{name}", "kernel"), at(path, "in_proj_weight"),
                       w.t().reshape(d, h, d // h))
                yield (key("params", f"{path}.{name}", "bias"), at(path, "in_proj_bias"),
                       m.in_proj_bias[i * d:(i + 1) * d].reshape(h, d // h))
            yield (key("params", f"{path}.out", "kernel"), at(path, "out_proj.weight"),
                   m.out_proj.weight.t().reshape(h, d // h, d))
            yield key("params", f"{path}.out", "bias"), at(path, "out_proj.bias"), m.out_proj.bias
            continue
        else:
            continue
        if getattr(m, "bias", None) is not None:
            yield key("params", path, "bias"), at(path, "bias"), m.bias


def export_flax_params(module: nn.Module) -> dict[str, np.ndarray]:
    """``module``'s parameters and running statistics as flat ``::``-keyed
    Flax variables (float32): the inverse of :func:`convert_flax_params`."""
    return {k: t.detach().float().cpu().numpy() for k, _, t in _flax_leaves(module)}


def flax_param_paths(module: nn.Module) -> dict[str, tuple[str, int]]:
    """Each Flax parameter's path (``"Dense_1/kernel"``, the names
    ``jax.tree_util`` paths join with "/") -> (the state-dict name that
    holds it, its rank in Flax's layout)."""
    out = {}
    for k, name, t in _flax_leaves(module):
        col, *path = k.split(SEP)
        if col == "params":
            out["/".join(path)] = (name, t.dim())
    return out
