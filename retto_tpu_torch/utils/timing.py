"""Timing utilities.

Port of ``retto_tpu/utils/timing.py:22-73``.  PyTorch returns from a CUDA
call before the card has finished, so a timed window ends with
``torch.cuda.synchronize()`` when the output holds a CUDA tensor; for CPU
tensors (and host values) the call has already finished when it returns.

``StageTimers`` is also the port's one span recorder: ``DevicePipeline``'s
``last_stats`` and ``PipelineMetrics.stage_time``, the server's batch span
and the ``retto.*`` ranges of a ``torch.profiler`` timeline all come from
its spans.
"""

from __future__ import annotations

import time
from collections import defaultdict
from typing import Any, Callable

import torch
import torch.autograd.profiler as _autograd_profiler

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


class _Span:
    """One span of ``StageTimers.time``: wall seconds into the timers' totals
    and, only while a profiler records, the range ``retto.<name>``."""

    __slots__ = ("timers", "name", "ids", "t0", "range")

    def __init__(self, timers: "StageTimers", name: str, ids: dict):
        self.timers, self.name, self.ids, self.range = timers, name, ids, None

    def __enter__(self) -> None:
        # a module-level flag, set for every thread by either profiler mode;
        # an idle record_function costs ~50x the check
        if _autograd_profiler._is_profiler_enabled:
            label = " ".join([f"retto.{self.name}"]
                             + [f"{k}={v}" for k, v in self.ids.items()])
            self.range = torch.profiler.record_function(label)
            self.range.__enter__()
        self.t0 = time.perf_counter()

    def __exit__(self, *exc) -> None:
        dt = time.perf_counter() - self.t0
        if self.range is not None:
            self.range.__exit__(*exc)
        self.timers.totals[self.name] += dt
        self.timers.counts[self.name] += 1


class StageTimers:
    """Named wall-clock spans (timing.py:47-73).  ``time(name, **ids)``
    adds the span's seconds to ``totals[name]`` and one to
    ``counts[name]``; while a ``torch.profiler`` records, it is also the
    range ``retto.<name> k=v ...`` on the thread that runs it, on the
    trace's clock beside the kernels it launched.  The ids go into the
    range's name: neither ``record_function``'s argument string nor
    keyword inputs reach a trace that records every thread.

    One object is written by one thread at a time: a worker thread fills
    its own and hands it over with its result, and the owner merges it
    (``merge``)."""

    def __init__(self):
        self.totals: dict[str, float] = defaultdict(float)
        self.counts: dict[str, int] = defaultdict(int)

    def time(self, name: str, **ids) -> _Span:
        return _Span(self, name, ids)

    def add(self, name: str, seconds: float, count: int = 1) -> None:
        """A span timed elsewhere (a pair of CUDA events)."""
        self.totals[name] += seconds
        self.counts[name] += count

    def merge(self, other: "StageTimers") -> None:
        for name, seconds in other.totals.items():
            self.add(name, seconds, other.counts[name])

    def stats(self) -> dict[str, float | int]:
        """``t_<name>`` seconds and ``n_<name>`` counts, flat."""
        out: dict[str, float | int] = {}
        for name, seconds in self.totals.items():
            out[f"t_{name}"] = seconds
            out[f"n_{name}"] = self.counts[name]
        return out

    def summary(self) -> dict[str, dict[str, float]]:
        return {
            k: {
                "total_s": round(self.totals[k], 4),
                "count": self.counts[k],
                "avg_ms": round(1000 * self.totals[k] / max(self.counts[k], 1), 3),
            }
            for k in self.totals
        }
