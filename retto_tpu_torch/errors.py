"""Exception hierarchy for retto-tpu.

Port copy of ``retto_tpu/errors.py``: the port imports nothing of the JAX
package, so it keeps its own copy of this host-only module.

Mirrors the reference's single error enum ``RettoError``
(retto-core/src/error.rs:1-21) as an idiomatic Python
exception tree.  Every variant of the Rust enum has a counterpart here;
backend-specific variants (ort, hf-hub) map onto the engine/weights errors.
"""

from __future__ import annotations


class RettoError(Exception):
    """Base class for all retto-tpu errors (ref: error.rs:2)."""


class RettoIOError(RettoError):
    """I/O failure (ref: error.rs IOError)."""


class RettoImageError(RettoError):
    """Image decode/encode failure (ref: error.rs ImageError)."""


class RettoShapeError(RettoError):
    """Tensor shape mismatch (ref: error.rs ShapeError)."""


class RettoEngineError(RettoError):
    """Model-execution backend failure (ref: error.rs OrtError)."""


class RettoWeightsError(RettoError):
    """Weight loading / conversion failure (ref: error.rs HfHubError)."""


class ModelNotFoundError(RettoError):
    """Model artifact could not be resolved (ref: error.rs:19-20)."""


class RettoConfigError(RettoError):
    """Invalid configuration value."""
