"""Pipeline metrics & observability.

SURVEY.md §5 plan: images/sec, p50/p99 latency, bucket occupancy and
padding-waste fractions — the metrics the reference lacks (it logs only a
single aggregate avg, retto-cli/src/main.rs:89-93).

Port copy of ``retto_tpu/utils/metrics.py::PipelineMetrics`` without the
``jax.profiler`` trace hook.
"""

from __future__ import annotations

import time
from collections import defaultdict
from contextlib import contextmanager
from dataclasses import dataclass, field

import numpy as np

__all__ = ["PipelineMetrics"]


@dataclass
class PipelineMetrics:
    """Counters accumulated across run()/run_many() calls."""

    images: int = 0
    crops: int = 0
    latencies_s: list[float] = field(default_factory=list)
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
            self.latencies_s.append(time.perf_counter() - t0)
            self.images += 1

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
        lat = np.asarray(self.latencies_s) if self.latencies_s else np.zeros(1)
        total = float(lat.sum())
        occupancy = {
            k: round(v[0] / v[1], 4) if v[1] else 1.0
            for k, v in self.bucket_fill.items()
        }
        return {
            "images": self.images,
            "crops": self.crops,
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
