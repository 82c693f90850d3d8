"""Reduction of a ``torch.profiler`` trace of the profiled sub-window:
device busy time (the union of kernel and memory-copy intervals), the
device operations by kernel name and by kind, the det epilogue's kernels,
and the longest idle gaps named by what the host was doing."""

from __future__ import annotations

from dataclasses import dataclass, field

import torch

__all__ = ["KINDS", "TraceSummary", "summarize", "union_seconds"]

# (kind, name fragments), first match wins, case-insensitive
KINDS = (
    ("db_epilogue", ("db_epilogue",)),
    ("memcpy_memset", ("memcpy", "memset")),
    ("cudnn_layout", ("nchwtonhwc", "nhwctonchw")),
    ("conv", ("xmma", "implicit_gemm", "conv")),
    ("gemm", ("gemm", "nvjet", "cutlass")),
    ("copy_cast", ("copy",)),
    ("elementwise", ("elementwise",)),
    ("reduce", ("reduce",)),
)

WINDOW = "bench.window"


def kind_of(name: str) -> str:
    low = name.lower()
    return next((k for k, marks in KINDS if any(m in low for m in marks)), "other")


def union_seconds(intervals: list[tuple[float, float]]) -> float:
    """Length of the union of (start, end) intervals, in their unit."""
    total, end = 0.0, -float("inf")
    for s, e in sorted(intervals):
        if s > end:
            total += e - s
            end = e
        elif e > end:
            total += e - end
            end = e
    return total


@dataclass
class TraceSummary:
    window_s: float
    busy_s: float
    epilogue_s: float
    epilogue_launches: int
    device_ops: list = field(default_factory=list)
    idle_gaps: list = field(default_factory=list)


def summarize(prof: torch.profiler.profile, top: int = 10, device: bool = True
              ) -> TraceSummary:
    """The profiled window is the CPU range ``bench.window``; device
    intervals are clipped to it.  Times in seconds.  ``device``: the trace
    must hold device operations (a CPU run's holds none)."""
    events = prof.events()
    win = [e for e in events if e.name == WINDOW]
    if not win:
        raise RuntimeError(f"the trace holds no {WINDOW!r} range")
    w0 = min(e.time_range.start for e in win)
    w1 = max(e.time_range.end for e in win)
    dev, host = [], []
    for e in events:
        if e.device_type == torch.autograd.DeviceType.CUDA:
            if getattr(e, "is_user_annotation", False) or e.name.startswith("bench."):
                continue
            s, t = max(e.time_range.start, w0), min(e.time_range.end, w1)
            if t > s:
                dev.append((s, t, e.name))
        elif e.name != WINDOW:
            host.append((e.time_range.start, e.time_range.end, e.name))
    if not dev and device:
        raise RuntimeError("the trace holds no device operation in the window")
    busy = union_seconds([(s, t) for s, t, _ in dev])
    by_name: dict[str, float] = {}
    by_kind: dict[str, float] = {}
    epi_s, epi_n = 0.0, 0
    for s, t, name in dev:
        by_name[name] = by_name.get(name, 0.0) + (t - s)
        k = kind_of(name)
        by_kind[k] = by_kind.get(k, 0.0) + (t - s)
        if k == "db_epilogue":
            epi_s += t - s
            epi_n += 1
    half = top // 2
    ops = [[f"kind:{k}", v / 1e6] for k, v in sorted(by_kind.items(), key=lambda kv: -kv[1])]
    names = [[n[:120], v / 1e6] for n, v in sorted(by_name.items(), key=lambda kv: -kv[1])]
    device_ops = ops[:half] + names[:top - min(half, len(ops))]
    # idle gaps: the complement of the busy union inside the window
    gaps, end = [], w0
    for s, t, _ in sorted(dev):
        if s > end:
            gaps.append((end, s))
        end = max(end, t)
    if w1 > end:
        gaps.append((end, w1))
    gaps.sort(key=lambda g: g[0] - g[1])
    idle = []
    for g0, g1 in gaps[:top]:
        # the shortest host range covering half the gap or more, else the
        # one overlapping it most
        covering, widest = None, None
        for s, t, name in host:
            ov = min(t, g1) - max(s, g0)
            if ov <= 0:
                continue
            if ov >= 0.5 * (g1 - g0) and (covering is None or t - s < covering[0]):
                covering = (t - s, name)
            if widest is None or ov > widest[0]:
                widest = (ov, name)
        name = covering[1] if covering else widest[1] if widest else "no host range"
        idle.append([name[:120], (g1 - g0) / 1e6])
    return TraceSummary(window_s=(w1 - w0) / 1e6, busy_s=busy / 1e6, epilogue_s=epi_s / 1e6,
                        epilogue_launches=epi_n, device_ops=device_ops, idle_gaps=idle)
