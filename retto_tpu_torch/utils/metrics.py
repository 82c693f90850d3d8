"""Pipeline metrics & observability.

SURVEY.md §5 plan: images/sec, p50/p99 latency, bucket occupancy and
padding-waste fractions — the metrics the reference lacks (it logs only a
single aggregate avg, retto-cli/src/main.rs:89-93).

Port copy of ``retto_tpu/utils/metrics.py``: ``PipelineMetrics`` as it is,
but for three additions (latencies kept for the newest ``WINDOW`` calls
only, so a server's ``/metrics`` does not grow with its uptime, the count of
crop-accumulator flushes that padded chunks of mixed shapes, and the count
of pages whose upload planes one native call a chunk packed), and
``profile_trace`` over ``torch.profiler`` in place of ``jax.profiler``.
"""

from __future__ import annotations

import time
from collections import defaultdict, deque
from contextlib import contextmanager
from dataclasses import dataclass, field

import numpy as np

__all__ = ["PipelineMetrics", "profile_trace"]

# the newest samples a latency or wait summary reads
WINDOW = 4096


@dataclass
class PipelineMetrics:
    """Counters accumulated across run()/run_many() calls."""

    images: int = 0
    crops: int = 0
    pad_concats: int = 0
    pages_packed_native: int = 0
    latencies_s: deque = field(default_factory=lambda: deque(maxlen=WINDOW))
    latency_total_s: float = 0.0  # over every call, for images_per_sec
    # bucket name -> [used_slots, padded_slots]
    bucket_fill: dict[str, list[int]] = field(
        default_factory=lambda: defaultdict(lambda: [0, 0])
    )
    # stage -> seconds
    stage_time: dict[str, float] = field(
        default_factory=lambda: defaultdict(float)
    )

    @contextmanager
    def measure_image(self):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.record_latency(time.perf_counter() - t0)
            self.images += 1

    def record_latency(self, seconds: float) -> None:
        self.latencies_s.append(seconds)
        self.latency_total_s += seconds

    @contextmanager
    def measure_stage(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.stage_time[name] += time.perf_counter() - t0

    def record_batch(self, bucket: str, used: int, total: int) -> None:
        f = self.bucket_fill[bucket]
        f[0] += used
        f[1] += total

    def summary(self) -> dict:
        # a snapshot: other threads append while a server reads
        lat = np.asarray(tuple(self.latencies_s)) if self.latencies_s else np.zeros(1)
        total = self.latency_total_s
        occupancy = {
            k: round(v[0] / v[1], 4) if v[1] else 1.0
            for k, v in self.bucket_fill.items()
        }
        return {
            "images": self.images,
            "crops": self.crops,
            "pad_concats": self.pad_concats,
            "pages_packed_native": self.pages_packed_native,
            "images_per_sec": round(self.images / total, 3) if total else 0.0,
            "latency_ms": {
                "p50": round(float(np.percentile(lat, 50)) * 1000, 2),
                "p90": round(float(np.percentile(lat, 90)) * 1000, 2),
                "p99": round(float(np.percentile(lat, 99)) * 1000, 2),
                "mean": round(float(lat.mean()) * 1000, 2),
            },
            "bucket_occupancy": occupancy,
            "padding_waste": {
                k: round(1.0 - v, 4) for k, v in occupancy.items()
            },
            "stage_time_s": {
                k: round(v, 4) for k, v in self.stage_time.items()
            },
        }


@contextmanager
def profile_trace(logdir: str):
    """``torch.profiler`` trace of the block: host (CPU) activity of every
    thread, the port's ``retto.*`` spans among it (``utils.timing``), and
    the card's kernels when CUDA is available.  On exit it writes a Chrome
    trace (``trace.json``) into ``logdir``, created if missing, which
    Perfetto (ui.perfetto.dev) or ``chrome://tracing`` opens; yields the
    profiler, whose ``key_averages()`` tables the same run."""
    import os

    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    # the default records host ranges of the starting thread only
    every_thread = torch._C._profiler._ExperimentalConfig(profile_all_threads=True)
    with profile(activities=activities, record_shapes=True,
                 experimental_config=every_thread) as prof:
        yield prof
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))
