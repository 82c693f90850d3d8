"""Run one cell of ``BENCHMARK.json`` once and print one JSON line.

    python3 -m benchmark.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

The cell names a configuration (``benchmark/configs/<name>.json``: the
checkpoints, their widths and the session settings) and a traffic mix
(``benchmark/traffic/<name>.json``).  A run builds the program under test,
``retto_tpu_torch.RettoSession(...).device_pipeline()`` on card 0, makes
its pages from the seed, warms up every shape the mix uses, then drives it
for ``--seconds`` in a closed loop: ``run_many`` on one batch of pages after
another, each call issued when the previous returns.

With ``--trace 0`` the line carries the cell's end-to-end metrics, with
``--trace 1`` its per-layer metrics, read by the files of
``benchmark/metrics/`` from the window's counters and from a
``torch.profiler`` trace of a profiled sub-window after it.  Every run then
frees the program and holds what the window served against the plain
float32 reference (``benchmark/reference``): each compared number and its
limit (``benchmark/limits/<cell>.json``) go to the last lines of standard
error and, under ``checks``, to the end of the result line.

A run exits non-zero and prints no result without a CUDA card (or with
fewer than the cell asks for), or when JAX, Flax, optax or the JAX package
is loaded once the window has closed.
"""

from __future__ import annotations

import argparse
import gc
import importlib.util
import json
import os
import sys
import threading
import time
from pathlib import Path

_T_IMPORT = time.perf_counter()
ROOT = Path(__file__).resolve().parent.parent
HERE = Path(__file__).resolve().parent
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "retto_tpu")


class Refused(SystemExit):
    """A run that must end without a result (exit code 2)."""

    def __init__(self, msg: str):
        print(f"benchmark: {msg}", file=sys.stderr, flush=True)
        super().__init__(2)


def process_age() -> float:
    """Seconds since this process started (Linux: from /proc), else since
    this module was imported."""
    try:
        ticks = os.sysconf("SC_CLK_TCK")
        start = int(Path("/proc/self/stat").read_text().rsplit(")", 1)[1].split()[19])
        uptime = float(Path("/proc/uptime").read_text().split()[0])
        return uptime - start / ticks
    except (OSError, ValueError, IndexError):
        return time.perf_counter() - _T_IMPORT


def cache_env(root: Path) -> None:
    """Every kernel and build cache at a fixed path inside the checkout."""
    cache = root / ".bench_cache"
    for var, sub in (("TRITON_CACHE_DIR", "triton"), ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TORCHINDUCTOR_CACHE_DIR", "inductor"), ("CUDA_CACHE_PATH", "cuda")):
        os.environ[var] = str(cache / sub)


def loaded_forbidden() -> list[str]:
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def load_cell(name: str, bench_path: Path = ROOT / "BENCHMARK.json") -> dict:
    """The cell, its configuration, mix, limits and metric entries."""
    bench = json.loads(bench_path.read_text())
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise Refused(f"no workload {name!r} in {bench_path.name}")
    cell = cells[name]
    from benchmark.traffic.pages import load_mix

    cfg = json.loads((HERE / "configs" / f"{cell['config']}.json").read_text())
    limits = json.loads((HERE / "limits" / f"{name}.json").read_text())
    per_layer = [m for m in bench["per_layer"] if name in m.get("workloads", [name])]
    e2e = [m for m in bench["end_to_end"] if name in m.get("workloads", [name])]
    return {"bench": bench, "cell": cell, "config": cfg, "mix": load_mix(cell["traffic"]),
            "limits": limits, "per_layer": per_layer, "end_to_end": e2e}


def read_metric(name: str, ctx: dict):
    """The reader ``benchmark/metrics/<name>.py``'s ``read(ctx)``: a number,
    or None where it finds nothing to read."""
    path = HERE / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"benchmark_metric_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read(ctx)


# --------------------------------------------------------------------- program
def build_program(cfg: dict, device: str, root: Path = ROOT):
    """The session and its fused pipeline, as the configuration states."""
    import numpy as np

    from retto_tpu_torch import RettoSession, SessionConfig
    from retto_tpu_torch.ops.charset import CharacterDict

    for kind, path in cfg["weights"].items():
        with np.load(root / path, allow_pickle=False) as z:
            meta = json.loads(str(z["__meta__"][()]))["overrides"]
        want = {k: v for k, v in cfg["models"][kind].items()}
        if {k: meta.get(k) for k in want} != want:
            raise ValueError(f"{path}: the checkpoint's architecture {meta} is not the "
                             f"configuration's {want}")
    session = RettoSession(
        SessionConfig.from_dict(cfg["session"]), preset=cfg["preset"],
        charset=CharacterDict((root / cfg["charset"]).read_text(encoding="utf-8").splitlines()),
        weights={k: str(root / v) for k, v in cfg["weights"].items()}, device=device)
    return session, session.device_pipeline()


def answers_of(results) -> list:
    """The program's OcrResults as the reference's PageAnswers."""
    import numpy as np

    from benchmark.reference.ocr import Answer, PageAnswer

    out = []
    for r in results:
        if isinstance(r, Exception):
            out.append(None)
            continue
        pa = PageAnswer()
        cls, texts = list(r.cls_result.labels), list(r.rec_result.texts)
        for k, b in enumerate(r.det_result.boxes):
            c = cls[k] if k < len(cls) else None
            pa.lines.append(Answer(np.asarray(b.box.pts, np.float64), float(b.score),
                                   c.label if c else -1, float(c.score) if c else 0.0,
                                   texts[k].text if k < len(texts) else ""))
        out.append(pa)
    return out


# ---------------------------------------------------------------- closed loop
def _sum_stats(acc: dict, stats: dict) -> None:
    for k, v in stats.items():
        if isinstance(v, (int, float)):
            acc[k] = acc.get(k, 0) + v


def drive_closed(dp, mix: dict, pool: list, seconds: float, trace: bool, cuda: bool,
                 seed: int = 0) -> dict:
    """Warm up every batch of the pool, then call ``run_many`` on the
    batches in turn for ``seconds``.  Of each batch's calls in the window
    the first is kept (for the FLOP count) and one drawn uniformly from the
    seed (reservoir sampling, for the judgement).  ``pages`` counts the
    pages answered, ``failed`` those that came back as an error or not at
    all."""
    import numpy as np
    import torch
    from torch.profiler import record_function

    b = mix["batch"]
    batches = [pool[i:i + b] for i in range(0, len(pool), b)]
    for _ in range(2):  # every shape of every batch: det chunks, cls + rec buckets
        for batch in batches:
            dp.run_many(batch)
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    sync()
    rng = np.random.default_rng([seed, 3])
    first: dict[int, list] = {}
    sample: dict[int, list] = {}
    seen = [0] * len(batches)
    stats: dict = {}
    pages = failed = 0
    ends = []
    t_ready = time.perf_counter()
    cap0 = dp.compile_count()
    cpu0 = (time.thread_time(), time.process_time())
    t0 = time.perf_counter()
    k = 0
    while True:
        i = k % len(batches)
        with record_function("bench.run_many"):
            res = dp.run_many(batches[i])
        ends.append(time.perf_counter() - t0)
        answered = sum(not isinstance(x, Exception) for x in res[:len(batches[i])])
        pages += answered
        failed += len(batches[i]) - answered
        seen[i] += 1
        first.setdefault(i, res)
        if rng.random() < 1.0 / seen[i]:
            sample[i] = res
        _sum_stats(stats, dp.last_stats)
        k += 1
        if ends[-1] >= seconds:
            break
    sync()
    wall = time.perf_counter() - t0
    cpu = [b - a for a, b in zip(cpu0, (time.thread_time(), time.process_time()))]
    out = {"cpu": cpu, "t_ready": t_ready, "wall": wall, "pages": pages, "failed": failed,
           "first": first, "sample": sample, "seen": seen, "stats": stats, "ends": ends,
           "captures": dp.compile_count() - cap0, "batches": batches, "trace": None,
           "judge_batches": int(mix.get("judge_batches", len(batches)))}
    if trace:
        out["trace"] = profile_window(
            lambda: [dp.run_many(batch) for batch in batches], cuda)
        out["trace_pages"] = [p for batch in batches for p in batch]
    return out


def profile_window(body, cuda: bool):
    """Run ``body`` under ``torch.profiler`` in the range ``bench.window``,
    ending in a synchronize; returns the trace summary."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    from benchmark.trace import summarize

    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    with profile(activities=acts) as prof:
        with record_function("bench.window"):
            body()
            if cuda:
                torch.cuda.synchronize()
    return summarize(prof, device=cuda)


# ----------------------------------------------------------------- judgement
def judge_closed(ref, run: dict, seed: int, judge_fn=None) -> dict:
    """Every page of the sampled call of each of ``judge_batches`` of the
    mix's batches (all by default), the batches drawn from the seed; a
    page without an answer is judged as one with no lines.  ``unanswered``
    counts every page of the window that came back as an error or not at
    all, judged or not."""
    import numpy as np

    from benchmark.reference.ocr import PageAnswer, judge

    rng = np.random.default_rng([seed, 4])
    keys = sorted(run["sample"])
    keep = sorted(rng.choice(keys, size=min(run["judge_batches"], len(keys)), replace=False))
    pages, answers = [], []
    for i in keep:
        batch = run["batches"][i]
        got = answers_of(run["sample"][i])[:len(batch)]
        pages.extend(batch)
        answers.extend(got + [None] * (len(batch) - len(got)))
    answers = [a if a is not None else PageAnswer() for a in answers]
    nums = (judge_fn or judge)(ref, pages, answers)
    nums["unanswered"] = run["failed"]
    return nums


def check(nums: dict, limits: dict) -> tuple[bool, dict]:
    """The compared numbers (those the cell's limits file names, then the
    count of the window's pages left without an answer, limit 0) beside
    their limits, and whether every one is within its limit."""
    checks = {name: {"value": float(nums[name]), "limit": lim}
              for name, lim in limits["limits"].items()}
    checks["unanswered"] = {"value": int(nums["unanswered"]), "limit": 0}
    return all(c["value"] <= c["limit"] for c in checks.values()), checks


# ------------------------------------------------------------------ the run
def run_cell(workload: str, seed: int, seconds: float, trace: bool, device: str = "cuda",
             require_cuda: bool = True, root: Path = ROOT, spec: dict | None = None,
             fault=None) -> dict:
    """One run; returns the result line's object.  ``spec`` replaces the
    cell ``load_cell`` reads, and ``fault(dp)`` may plant a fault under the
    timed path (both for tests)."""
    import torch

    spec = spec or load_cell(workload, root / "BENCHMARK.json")
    chips = spec["cell"]["chips"]
    cuda = device.startswith("cuda")
    if require_cuda:
        if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
            have = torch.cuda.device_count() if torch.cuda.is_available() else 0
            raise Refused(f"the cell needs {chips} CUDA card(s); this machine has {have}")
    from benchmark.traffic.pages import make_pool

    cfg, mix = spec["config"], spec["mix"]
    session, dp = build_program(cfg, device, root)
    if fault is not None:
        fault(dp)
    pool = make_pool(mix, seed)
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    run = drive_closed(dp, mix, pool, seconds, trace, cuda, seed)
    failed = run["failed"]
    attempted = run["pages"] + failed
    ends = run["ends"]
    per_s = [sum(1 for e in ends if j <= e < j + 1) for j in range(int(run["wall"]))]
    caller, process = (c / run["wall"] for c in run["cpu"])
    print(f"closed loop: {len(ends)} calls; calls a second {per_s}", file=sys.stderr)
    print(f"host: {os.cpu_count()} cpus, torch threads {torch.get_num_threads()}, python "
          f"threads {threading.active_count()}; over the window the calling thread was busy "
          f"{caller:.3f} of the time and the process used {process:.3f} cpus", file=sys.stderr)
    setup_s = process_age() - (time.perf_counter() - run["t_ready"])
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    found = loaded_forbidden()
    if found:
        raise Refused(f"modules of JAX or the JAX package are loaded: {', '.join(found)}")
    card = torch.cuda.get_device_name(0) if cuda else "cpu"
    metrics, breakdown = {}, None
    if not trace:
        ctx = _e2e_context(run, mix, setup_s)
        for m in spec["end_to_end"]:
            metrics[m["name"]] = {"value": ctx[m["name"]], "unit": m["unit"]}
    else:
        ctx = _layer_context(run, mix, cfg, card, root, cuda)
        for m in spec["per_layer"]:
            v = read_metric(m["name"], ctx)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
        if run["trace"] is not None:
            breakdown = {"device_ops": run["trace"].device_ops,
                         "idle_gaps": run["trace"].idle_gaps}
    # free the program before the reference runs
    session.close()
    del session, dp
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    from benchmark.reference.ocr import Reference

    if cuda:
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    t_ref = time.perf_counter()
    ref = Reference(cfg, root, torch.device(device))
    nums = judge_closed(ref, run, seed)
    print(f"reference: {time.perf_counter() - t_ref:.3f} s", file=sys.stderr)
    correct, checks = check(nums, spec["limits"])
    for name, v in nums.items():
        if name not in checks:
            print(f"reading {name} = {v!r} (not compared)", file=sys.stderr)
    device_doc = {"platform": "gpu" if cuda else "cpu", "kind": card,
                  "count": chips if cuda else 0, "memory_peak_bytes": int(peak)}
    if trace and run["trace"] is not None:
        device_doc["busy_s"] = run["trace"].busy_s
        device_doc["window_s"] = run["trace"].window_s
    out = {"correct": correct, "attempted": int(attempted), "failed": int(failed),
           "metrics": metrics, "device": device_doc}
    if breakdown is not None:
        out["breakdown"] = breakdown
    out["checks"] = checks
    return out


def _e2e_context(run: dict, mix: dict, setup_s: float) -> dict:
    from benchmark.stats import rate

    return {"setup_s": setup_s, "pages_per_s": rate(run["pages"], run["wall"])}


def _layer_context(run: dict, mix: dict, cfg: dict, card: str, root: Path, cuda: bool) -> dict:
    """What the per-layer readers read (``benchmark/metrics``)."""
    from benchmark.flops import FlopCounter, epilogue_bytes, peaks_of
    from benchmark.reference.ocr import det_canvas

    ctx = {"captures": run["captures"], "trace": run["trace"], "card": card,
           "pages": run["pages"], "wall": run["wall"], "stats": run["stats"]}
    counter = FlopCounter(cfg, root)
    s = cfg["session"]
    flops = 0.0
    for i, res in run["first"].items():
        f = 0.0
        for page, r in zip(run["batches"][i], res):
            if isinstance(r, Exception):
                continue
            rh, rw, _, _ = det_canvas(page.shape[0], page.shape[1], s)
            f += counter.det_flops(rh, rw)
            for b in r.det_result.boxes:
                cw, w = counter.crop_widths(b.box.pts)
                f += counter.cls_flops(cw) + counter.rec_flops(w)
        flops += f * run["seen"][i]
    ctx["flops"] = flops
    if cuda:
        ctx["peak_flops"], ctx["peak_bytes"] = peaks_of(card)
    if run["trace"] is not None:
        nbytes = 0
        for page in run["trace_pages"]:
            _, _, dh, dw = det_canvas(page.shape[0], page.shape[1], s)
            nbytes += epilogue_bytes(dh // 2, dw // 2, 2, 2)
        ctx["epilogue_bytes"] = nbytes
    return ctx


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    cache_env(ROOT)
    out = run_cell(args.workload, args.seed, args.seconds, bool(args.trace))
    print(f"correct = {out['correct']}", file=sys.stderr)
    for name, c in out["checks"].items():
        print(f"check {name} = {c['value']!r} (limit {c['limit']!r})", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
