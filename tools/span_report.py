"""The fused pipeline's spans on one benchmark cell: where each thread's time
goes, what the card does meanwhile, and what tracing costs.

    python3 tools/span_report.py --workload mobile.batch16 --seed 7 [--keep DIR]

Builds the cell's program as ``python3 -m benchmark.run`` does
(``benchmark.run.build_program``; the pages from ``--seed``), warms every
batch of the pool twice, then runs passes over the pool's batches, one
``run_many`` a batch, with no profiler and under
``retto_tpu_torch.utils.metrics.profile_trace`` in turns (off, on, on, off),
and prints one JSON line:

* ``setup_s``: the session's build, its ``load_weights`` spans, the warm-up,
  and the graph caches' ``capture`` spans within it;
* ``ms_per_call``: each pass's host clock a call (ending in a synchronize),
  untraced and traced: the cost of tracing on; ``always_on_us``, the host
  microseconds of an idle span and of a timing event's record;
* ``last_stats_ms_per_call`` and ``last_stats_n_per_call``: the untraced
  passes' ``last_stats`` seconds (``t_*``) and counts (``n_*``), summed and
  divided by the calls; ``counters_per_call``, the other counters of
  ``last_stats`` likewise (``images``, ``pages_packed_native``, ...), and
  ``calls_packed_natively``, the untraced calls whose pages the native
  chunk pack wrote every one of, against the calls; ``calling_cover`` is the
  calling thread's spans over ``t_total``, without and with ``t_lock_wait``
  (which sums every thread's);
* from the last traced pass, by thread (calling, upload, fetch, post): each
  ``retto.*`` span's ms a call; ``calling_cover_traced``, the union of the
  calling thread's spans over its calls; the upload thread's ``upload`` and
  ``lock_wait`` shares of the pass's wall time;
* ``device``: busy ms a call (the union of kernel and copy intervals),
  ``t_det_device`` and ``t_clsrec_device`` a call (untraced passes);
* ``idle_ms_by_span``: the card's idle time a call split by the calling
  thread's span at each moment (``none`` between spans), and beside it by
  the upload thread's;
* ``idle_gaps``: the longest gaps, each with the calling and the upload
  thread's spans at its middle and the shortest calling-thread range that
  covers half of it or more (the benchmark's breakdown's naming).

``--device cpu --tiny`` rehearses it on the CPU at the benchmark tests'
small size.  ``--keep DIR`` keeps the last traced pass's ``trace.json``.
"""

from __future__ import annotations

import argparse
import json
import shutil
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

SPAN = "retto."
CALL = "span_report.call"
HOST_CATS = ("user_annotation", "cpu_op", "python_function")
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


def _name(e: dict) -> str:
    return e["name"].split(" ")[0][len(SPAN):]


def _overlap(a0: float, a1: float, ranges: list) -> list:
    return [(max(a0, s), min(a1, t), n) for s, t, n in ranges if min(a1, t) > max(a0, s)]


def _at(x: float, ranges: list) -> str:
    return next((n for s, t, n in ranges if s <= x < t), "none")


def analyse(trace: list[dict], calls: int) -> dict:
    """The traced pass from its Chrome trace events (host ranges by the
    thread that ran them; times in us): spans by thread, coverage, idle
    time by span."""
    from benchmark.trace import union_seconds

    host = [e for e in trace if e.get("ph") == "X" and e.get("cat") in HOST_CATS]
    spans = [e for e in host if e["name"].startswith(SPAN)]
    by_name: dict[str, set] = {}
    for e in spans:
        by_name.setdefault(_name(e), set()).add(e["tid"])
    caller = next(iter(by_name.get("decode", {None})))
    uploader = next(iter(by_name.get("upload", {None}) - {caller}))
    role = {t: "fetch" for t in by_name.get("fetch", set())}
    role.update({t: "post" for t in by_name.get("contours", set())})
    role.update({caller: "calling", uploader: "upload"})
    per: dict[str, dict[str, float]] = {}
    ranges: dict[str, list] = {"calling": [], "upload": []}
    for e in spans:
        r = role.get(e["tid"], "other")
        d = per.setdefault(r, {})
        d[_name(e)] = d.get(_name(e), 0.0) + e["dur"] / 1e3
        if r in ranges:
            ranges[r].append((e["ts"], e["ts"] + e["dur"], _name(e)))
    for r in ranges.values():
        r.sort()
    per = {r: {k: v / calls for k, v in sorted(d.items())} for r, d in per.items()}
    win = sorted((e["ts"], e["ts"] + e["dur"]) for e in host if e["name"] == CALL)
    w0, w1 = win[0][0], win[-1][1]
    wall = sum(t - s for s, t in win)
    out = {"spans_ms_per_call": per,
           "calling_cover_traced": union_seconds([(s, t) for s, t, _ in ranges["calling"]])
           / wall,
           "upload_busy_share": per.get("upload", {}).get("upload", 0.0) * calls * 1e3
           / (w1 - w0),
           "upload_lock_wait_share": per.get("upload", {}).get("lock_wait", 0.0) * calls
           * 1e3 / (w1 - w0)}
    dev = sorted((max(e["ts"], w0), min(e["ts"] + e["dur"], w1)) for e in trace
                 if e.get("ph") == "X" and e.get("cat") in DEVICE_CATS
                 and min(e["ts"] + e["dur"], w1) > max(e["ts"], w0))
    if not dev:
        return out
    gaps, end = [], w0
    for s, t in dev:
        if s > end:
            gaps.append((end, s))
        end = max(end, t)
    if w1 > end:
        gaps.append((end, w1))
    out["device_busy_ms_per_call"] = union_seconds(dev) / 1e3 / calls
    idle: dict[str, dict[str, float]] = {}
    for who in ("calling", "upload"):
        d: dict[str, float] = {}
        for g0, g1 in gaps:
            covered = 0.0
            for s, t, n in _overlap(g0, g1, ranges[who]):
                d[n] = d.get(n, 0.0) + (t - s)
                covered += t - s
            d["none"] = d.get("none", 0.0) + (g1 - g0) - covered
        idle[who] = {k: v / 1e3 / calls for k, v in sorted(d.items(), key=lambda kv: -kv[1])}
    out["idle_ms_by_span"] = idle
    ops = [(e["ts"], e["ts"] + e["dur"], e["name"]) for e in host
           if e["tid"] == caller and not e["name"].startswith(SPAN) and e["name"] != CALL]
    named = []
    for g0, g1 in sorted(gaps, key=lambda g: g[0] - g[1])[:10]:
        cover = [(t - s, n) for s, t, n in ops if min(t, g1) - max(s, g0) >= 0.5 * (g1 - g0)]
        mid = (g0 + g1) / 2
        named.append({"ms": (g1 - g0) / 1e3, "calling": _at(mid, ranges["calling"]),
                      "upload": _at(mid, ranges["upload"]),
                      "host_range": min(cover)[1][:80] if cover else "no host range"})
    out["idle_gaps"] = named
    return out


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--tiny", action="store_true", help="the benchmark tests' small size")
    ap.add_argument("--keep", default="", help="directory for the traced pass's trace.json")
    args = ap.parse_args(argv)
    import torch
    from torch.profiler import record_function

    from benchmark import run as R
    from benchmark.traffic.pages import make_pool
    from retto_tpu_torch.utils.metrics import profile_trace
    from retto_tpu_torch.utils.timing import StageTimers

    cuda = args.device.startswith("cuda")
    if args.tiny:
        from benchmark.tests.conftest import tiny_spec

        spec = tiny_spec(args.workload)
    else:
        spec = R.load_cell(args.workload)
    R.cache_env(ROOT)
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    t = time.perf_counter()
    session, dp = R.build_program(spec["config"], args.device)
    build_s = time.perf_counter() - t
    pool = make_pool(spec["mix"], args.seed)
    b = spec["mix"]["batch"]
    batches = [pool[i:i + b] for i in range(0, len(pool), b)]
    t = time.perf_counter()
    for _ in range(2):
        for batch in batches:
            dp.run_many(batch)
    sync()
    warm_s = time.perf_counter() - t
    caches = [c for r in dp._replicas for c in (r.det_graphs, r.clsrec_graphs)]
    setup = {"build": build_s, "load_weights": session.timers.totals.get("load_weights", 0.0),
             "warm_up": warm_s, "capture": sum(c.capture_s for c in caches),
             "graphs": dp.compile_count()}

    # the always-on cost: an idle span, and a timing event's record
    timers, n = StageTimers(), 20000
    t = time.perf_counter()
    for _ in range(n):
        with timers.time("x", sid=1, chunk=2):
            pass
    cost_us = {"span": (time.perf_counter() - t) / n * 1e6}
    if cuda:
        ev = torch.cuda.Event(enable_timing=True)
        t = time.perf_counter()
        for _ in range(n):
            ev.record()
        sync()
        cost_us["event_record"] = (time.perf_counter() - t) / n * 1e6

    stats: dict = {}
    packed_calls = [0, 0]

    def one_pass(keep: bool) -> float:
        t0 = time.perf_counter()
        for batch in batches:
            with record_function(CALL):
                dp.run_many(batch)
            if keep:
                R._sum_stats(stats, dp.last_stats)
                packed_calls[0] += (dp.last_stats.get("pages_packed_native")
                                    == dp.last_stats["images"])
                packed_calls[1] += 1
        sync()
        return (time.perf_counter() - t0) * 1e3 / len(batches)

    trace_dir = Path(tempfile.mkdtemp(prefix="span_report_"))
    ms: dict[str, list] = {"untraced": [], "traced": []}
    for traced in (False, True, True, False):
        if traced:
            with profile_trace(str(trace_dir)):
                ms["traced"].append(one_pass(False))
        else:
            ms["untraced"].append(one_pass(True))
    calls = len(batches)
    last = {k: v * 1e3 / (2 * calls) for k, v in sorted(stats.items()) if k.startswith("t_")}
    counts = {k: v / (2 * calls) for k, v in sorted(stats.items()) if k.startswith("n_")}
    counters = {k: v / (2 * calls) for k, v in sorted(stats.items())
                if not k.startswith(("t_", "n_"))}
    calling = ("decode", "upload_wait", "mask_fetch", "contours_wait", "score", "flush",
               "clsrec_dispatch", "clsrec_wait", "texts", "assemble")
    own = sum(last.get(f"t_{n}", 0.0) for n in calling)
    out = {"workload": args.workload, "seed": args.seed,
           "card": torch.cuda.get_device_name(0) if cuda else "cpu",
           "calls": calls, "pages_a_call": b, "setup_s": setup, "ms_per_call": ms,
           "always_on_us": cost_us,
           "last_stats_ms_per_call": last, "last_stats_n_per_call": counts,
           "counters_per_call": counters, "calls_packed_natively": packed_calls,
           "calling_cover": [own / last["t_total"],
                             (own + last.get("t_lock_wait", 0.0)) / last["t_total"]],
           "device": {"det_ms_per_call": last.get("t_det_device"),
                      "clsrec_ms_per_call": last.get("t_clsrec_device")}}
    out.update(analyse(json.loads((trace_dir / "trace.json").read_text())["traceEvents"], calls))
    if args.keep:
        Path(args.keep).mkdir(parents=True, exist_ok=True)
        shutil.copy(trace_dir / "trace.json", Path(args.keep) / f"{args.workload}.trace.json")
    shutil.rmtree(trace_dir, ignore_errors=True)
    session.close()
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
