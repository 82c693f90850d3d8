"""Checkpoint reading and writing.

Port of ``retto_tpu/weights/store.py:27-101``: a checkpoint is a flat
``.npz`` whose keys are the Flax variable paths joined with ``::``
(``params::ConvBNAct_0::Conv_0::kernel``), plus a ``__meta__`` JSON entry
that self-describes the architecture (``{"preset": ..., "overrides":
{...}}``).  The port reads the same files; it keeps the keys flat, because
``weights.convert`` maps each key on its own.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Any, Mapping

import numpy as np

from ..errors import ModelNotFoundError, RettoWeightsError

__all__ = ["SEP", "load_params", "load_params_meta", "save_params"]

SEP = "::"
_META_KEY = "__meta__"


def load_params_meta(
    path: str | Path,
) -> tuple[dict[str, np.ndarray], dict[str, Any] | None]:
    """(flat ``::``-keyed arrays, self-description or None)."""
    path = Path(path)
    if not path.exists():
        raise ModelNotFoundError(str(path))
    try:
        with np.load(path, allow_pickle=False) as z:
            meta = None
            if _META_KEY in z.files:
                meta = json.loads(str(z[_META_KEY][()]))
            flat = {k: z[k] for k in z.files if k != _META_KEY}
            return flat, meta
    except (OSError, ValueError) as e:
        raise RettoWeightsError(f"failed to load weights from {path}: {e}") from e


def load_params(path: str | Path) -> dict[str, np.ndarray]:
    """The checkpoint's flat ``::``-keyed arrays without its self-description
    (``retto_tpu/weights/store.py:77-78``, which returns the nested tree)."""
    return load_params_meta(path)[0]


def save_params(path: str | Path, flat: Mapping[str, np.ndarray],
                meta: Mapping[str, Any] | None = None) -> None:
    """Write flat ``::``-keyed Flax variables (``weights.convert.
    export_flax_params``) as the JAX package's ``save_params`` does
    (store.py:53-74): an ``.npz`` that both packages load, with ``meta``
    (``{"preset": ..., "overrides": {...}}``) as its ``__meta__`` entry."""
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    out = {k: np.asarray(v) for k, v in flat.items()}
    if meta is not None:
        out[_META_KEY] = np.asarray(json.dumps(dict(meta)))
    np.savez(path, **out)
