"""Timing utilities.

Port of ``retto_tpu/utils/timing.py:22-73``.  PyTorch returns from a CUDA
call before the card has finished, so a timed window ends with
``torch.cuda.synchronize()`` when the output holds a CUDA tensor; for CPU
tensors (and host values) the call has already finished when it returns.
"""

from __future__ import annotations

import time
from collections import defaultdict
from contextlib import contextmanager
from typing import Any, Callable

import torch

__all__ = ["device_fetch_sync", "time_fn", "StageTimers"]


def _leaves(out: Any):
    if isinstance(out, torch.Tensor):
        yield out
    elif isinstance(out, dict):
        for v in out.values():
            yield from _leaves(v)
    elif isinstance(out, (list, tuple)):
        for v in out:
            yield from _leaves(v)


def device_fetch_sync(out: Any) -> None:
    """Wait until every CUDA tensor in ``out`` (a tensor or a nest of
    lists, tuples and dicts) is computed (timing.py:22-29)."""
    devices = {t.device for t in _leaves(out) if t.is_cuda}
    for dev in devices:
        torch.cuda.synchronize(dev)


def time_fn(
    fn: Callable, *args, iters: int = 30, warmup: int = 2, **kw
) -> tuple[float, Any]:
    """(seconds per iteration, last output).  Chains ``iters`` calls and
    synchronises once at the end (timing.py:32-44)."""
    out = None
    for _ in range(warmup):
        out = fn(*args, **kw)
    device_fetch_sync(out)
    t0 = time.perf_counter()
    for _ in range(iters):
        out = fn(*args, **kw)
    device_fetch_sync(out)
    return (time.perf_counter() - t0) / iters, out


class StageTimers:
    """Named wall-clock accumulators (timing.py:47-73)."""

    def __init__(self):
        self.totals: dict[str, float] = defaultdict(float)
        self.counts: dict[str, int] = defaultdict(int)

    @contextmanager
    def time(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.totals[name] += time.perf_counter() - t0
            self.counts[name] += 1

    def summary(self) -> dict[str, dict[str, float]]:
        return {
            k: {
                "total_s": round(self.totals[k], 4),
                "count": self.counts[k],
                "avg_ms": round(1000 * self.totals[k] / max(self.counts[k], 1), 3),
            }
            for k in self.totals
        }
