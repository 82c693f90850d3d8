"""Where the time goes in the port's fused pipeline on one CUDA card.

Builds ``retto_tpu_torch.RettoSession`` on ``cuda`` with the mobile
checkpoints (``transfer_format="yuv420"``), warms it, then runs the
bench.py config-3 workload (16 gray 960x704 fixture pages, each fixture
page twice) under ``torch.profiler`` and prints one JSON line:

* ``wall_ms``: host clock around one ``run_many`` ending in a synchronize;
* ``device_busy_ms``: the union of the CUDA kernel and memcpy intervals in
  that window, and ``device_idle_share`` = 1 - busy / wall;
* ``kernels``: the top device-time entries of ``key_averages()``;
* ``host_phases``: the pipeline's own ``last_stats`` (seconds).

The Chrome trace goes to ``chiprun_out/torch_pipeline_trace.json``.

    python3 tools/profile_torch_pipeline.py
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from retto_tpu_torch import RettoSession, SessionConfig  # noqa: E402
from retto_tpu_torch.ops import db_pack  # noqa: E402
from retto_tpu_torch.ops.charset import CharacterDict  # noqa: E402


def _union_ms(intervals: list[tuple[float, float]]) -> float:
    total, end = 0.0, -1.0
    for s, e in sorted(intervals):
        if s > end:
            total += e - s
            end = e
        elif e > end:
            total += e - end
            end = e
    return total / 1e3  # profiler times are in us


def main() -> None:
    if not torch.cuda.is_available():
        sys.exit("needs a CUDA card")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=30, check=True).stdout.strip()
    fx = np.load(ROOT / "retto_tpu_torch" / "testdata" / "smoke_pages.npz")
    chars = CharacterDict((ROOT / "trained_weights" / "charset.txt").read_text().splitlines())
    cfg = SessionConfig()
    cfg.engine.transfer_format = "yuv420"
    dp = RettoSession(cfg, charset=chars, weights={
        k: str(ROOT / "trained_weights" / f"{k}.npz") for k in ("det", "cls", "rec")
    }, device="cuda").device_pipeline()
    pages = [np.repeat(p[..., None], 3, axis=2) for p in fx["pages"]] * 2
    for _ in range(3):
        dp.run_many(pages)
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        db_pack.binarize_dilate_pack_rows_batch.launches = 0
        t0 = time.perf_counter()
        dp.run_many(pages)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    launches = db_pack.binarize_dilate_pack_rows_batch.launches
    intervals = []
    for ev in prof.events():
        if ev.device_type == torch.autograd.DeviceType.CUDA:
            intervals.append((ev.time_range.start, ev.time_range.end))
    busy_ms = _union_ms(intervals)
    rows = []
    for a in prof.key_averages():
        dev_us = getattr(a, "self_device_time_total", 0) or getattr(a, "self_cuda_time_total", 0)
        if dev_us > 0:
            rows.append((dev_us, a.key, a.count))
    rows.sort(reverse=True)
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    prof.export_chrome_trace(str(out_dir / "torch_pipeline_trace.json"))
    print(json.dumps({
        "card": smi,
        "pages": len(pages),
        "wall_ms": wall_ms,
        "images_per_s": len(pages) / wall_ms * 1e3,
        "device_busy_ms": busy_ms,
        "device_idle_share": 1.0 - busy_ms / wall_ms,
        "device_events": len(intervals),
        "db_pack_launches": launches,
        "kernels": [{"name": k[:90], "device_ms": us / 1e3, "count": c}
                    for us, k, c in rows[:15]],
        "host_phases": {k: v for k, v in dp.last_stats.items()},
    }), flush=True)


if __name__ == "__main__":
    main()
