"""Character dictionary for CTC decoding.

Port copy of ``retto_tpu/ops/charset.py``: the port imports nothing of the JAX
package, so it keeps its own copy of this host-only module.

Mirrors the reference's RecCharacter (rec_processor.rs:22-46): the dict file
is one character per line; ``"blank"`` is prepended at index 0 and a single
space appended at the end.  Ignored tokens default to [0] (the blank), set
by the session at session.rs:66.
"""

from __future__ import annotations

from pathlib import Path
from typing import Iterable, Sequence

import numpy as np

from ..errors import ModelNotFoundError

__all__ = ["CharacterDict", "ascii_charset"]


def ascii_charset() -> list[str]:
    """Printable-ASCII charset (digits, letters, punctuation) — the built-in
    dict used when no PP-OCR keys file is available (no-network envs)."""
    return [chr(c) for c in range(33, 127)]


class CharacterDict:
    def __init__(self, chars: Iterable[str], ignored_tokens: Sequence[int] = (0,)):
        chars = list(chars)
        # insert_special_char semantics (rec_processor.rs:39-41)
        self.chars: list[str] = ["blank", *chars, " "]
        self.ignored_tokens = tuple(ignored_tokens)

    @classmethod
    def from_file(cls, path: str | Path, ignored_tokens: Sequence[int] = (0,)) -> "CharacterDict":
        p = Path(path)
        if not p.exists():
            raise ModelNotFoundError(str(p))
        lines = [ln.strip("\n\r") for ln in p.read_text(encoding="utf-8").splitlines()]
        return cls([ln.strip() for ln in lines], ignored_tokens)

    def __len__(self) -> int:
        return len(self.chars)

    @property
    def num_classes(self) -> int:
        return len(self.chars)

    def encode(self, text: str) -> list[int]:
        """Char -> index (for training targets); unknown chars are skipped."""
        lookup = getattr(self, "_lookup", None)
        if lookup is None:
            lookup = {c: i for i, c in enumerate(self.chars)}
            lookup.pop("blank", None)
            self._lookup = lookup
        return [lookup[c] for c in text if c in lookup]

    def decode_indices(
        self, idx: np.ndarray, keep: np.ndarray
    ) -> list[str]:
        """Join surviving steps to strings (rec_processor.rs:77-93).
        idx: [N, T] int, keep: [N, T] bool (from ctc_greedy_decode), with
        ignored tokens additionally masked out here."""
        idx = np.asarray(idx)
        keep = np.asarray(keep)
        for tok in self.ignored_tokens:
            keep = keep & (idx != tok)
        out = []
        for row_idx, row_keep in zip(idx, keep):
            kept = row_idx[row_keep]
            out.append("".join(self.chars[i] for i in kept))
        return out
