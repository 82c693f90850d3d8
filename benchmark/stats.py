"""The arithmetic of the end-to-end metrics."""

from __future__ import annotations

__all__ = ["rate"]


def rate(count: float, seconds: float) -> float:
    """Work per second over a window of ``seconds``."""
    if seconds <= 0:
        raise ValueError("a window of no time")
    return count / seconds
