"""The det-epilogue kernel (``csrc/db_pack.cu``) alone on the card.

    python3 retto_tpu_torch/tools/epilogue_probe.py [--root CHECKOUT] [--label NAME]

Each timed call is first held bit-exact to its plain version.  Times, as
device ms per launch from a CUDA graph of 100 launches (``device_ms``):
the main mode (bf16 logits at [B, 512, 384], pool 2) at B = 1, 4 and 16,
with the least-squares line of time against bytes (its intercept the fixed
cost of a launch, its slope the rate at which the kernel moves bytes,
beside the card's 3.35 TB/s) and, by the same timer, a one-element fill
(what any launch in a graph costs); the mask-only mode at B = 4; the ONNX path's
mode ([4, 1024, 768] float32 probabilities, pool 4); the one-map entry
point at [512, 384].  Then each template instance's registers, shared
memory and spills as ptxas reported them.

``--root`` imports ``retto_tpu_torch`` from another checkout (a ``git
archive`` of another commit in a directory that ``.gitignore`` lists) and
builds that checkout's kernel, so two trees can be timed in turns on one
card in one call.  The first line names the card and its power limit, the
last is one JSON object.  ``chip_smoke.py`` phase kernel uses the timers,
the sweep and the ptxas reader.
"""

from __future__ import annotations

import argparse
import json
import math
import re
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

REPO = Path(__file__).resolve().parents[2]
HBM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3 (NVIDIA data sheet)
LOGIT_THRESH = math.log(0.3 / 0.7)
MAIN_HW = (512, 384)  # stride-2 logits of a 1024x768 det bucket
MAIN_BATCH = 4  # the fused path's det chunk
SWEEP_BATCHES = (1, 4, 16)
ONNX_SHAPE = (4, 1024, 768)  # full-resolution float32 probabilities, pool 4
_INSTANCE = re.compile(r"db_epilogue_kernelI(13__nv_bfloat16|f)Li(\d)E")
_FUNCTION_LINE = ("Compiling entry function", "Function properties for")


def cuda_ms(fn, iters: int) -> float:
    """Mean ms per call with CUDA events around ``iters`` eager calls: the
    larger of the host's issue time and the device time."""
    for _ in range(10):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def device_ms(fn, per_graph: int = 100, replays: int = 20) -> float:
    """Device time per call: ``per_graph`` calls captured in one CUDA graph
    (the ctypes launchers launch on the capturing stream), the graph
    replayed between CUDA events, so no host work is in the number.  The
    input stays in the 50 MB L2 between calls, as the det head's output is
    when the pipeline's epilogue reads it."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(per_graph):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (replays * per_graph)


def host_ms(fn, iters: int = 2000) -> float:
    """Host time per wrapper call: the Python loop's clock, with the device
    far from full (each call's kernel takes less time than its issue)."""
    fn()
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(iters):
        fn()
    ms = (time.perf_counter() - t) / iters * 1e3
    torch.cuda.synchronize()
    return ms


def epilogue_bytes(shape: tuple[int, int, int], itemsize: int, pool: int | None) -> int:
    """Bytes the epilogue must move: the map read once, the mask
    [B, H/8, W] and, unless ``pool`` is None, the prob map
    [B, H/pool, W/pool] written once."""
    b, h, w = shape
    n = b * h * w * itemsize + b * (h // 8) * w
    return n if pool is None else n + b * (h // pool) * (w // pool)


def bound_ms(nbytes: int) -> float:
    return nbytes / HBM_BYTES_PER_S * 1e3


def fit_line(points: list[tuple[int, float]]) -> tuple[float, float]:
    """Least squares ``ms = fixed + bytes / rate`` over (bytes, ms) points:
    (fixed in ms, rate in bytes/s; inf where the time does not grow)."""
    x = np.array([p[0] for p in points], np.float64)
    y = np.array([p[1] for p in points], np.float64)
    slope, fixed = np.polyfit(x, y, 1)
    return float(fixed), (float(1e3 / slope) if slope > 0 else math.inf)


def ptxas_resources(log: str) -> dict[str, dict[str, int]]:
    """Each template instance of ``db_epilogue_kernel`` in ``nvcc -Xptxas
    -v`` output, keyed "bf16_pool2" etc.: registers, smem (bytes),
    spill_stores and spill_loads (bytes)."""
    out: dict[str, dict[str, int]] = {}
    cur = None
    for line in log.splitlines():
        if any(k in line for k in _FUNCTION_LINE):
            m = _INSTANCE.search(line)
            cur = None
            if m:
                dtype = "bf16" if m.group(1).endswith("bfloat16") else "f32"
                cur = out.setdefault(f"{dtype}_pool{m.group(2)}", {})
            continue
        if cur is None:
            continue
        if m := re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line):
            cur["spill_stores"], cur["spill_loads"] = int(m.group(1)), int(m.group(2))
        if m := re.search(r"Used (\d+) registers", line):
            cur["registers"] = int(m.group(1))
        if m := re.search(r"(\d+) bytes smem", line):
            cur["smem"] = int(m.group(1))
    return out


def _exact(got, ref) -> bool:
    got = got if isinstance(got, tuple) else (got,)
    ref = ref if isinstance(ref, tuple) else (ref,)
    return all(torch.equal(a, b) for a, b in zip(got, ref))


def batch_sweep(db_pack, gen: torch.Generator, batches=SWEEP_BATCHES) -> dict:
    """The main mode at each batch of ``batches`` (H, W = ``MAIN_HW``):
    device ms per launch against its bytes, each launch first held
    bit-exact to the plain version, and the fitted line."""
    points = []
    for b in batches:
        x = (torch.randn((b, *MAIN_HW), generator=gen, device="cuda") * 3).to(torch.bfloat16)
        args = (x, LOGIT_THRESH, True, 2, True)
        got = db_pack.db_epilogue(*args)
        torch.cuda.synchronize()
        if not _exact(got, db_pack.db_epilogue_plain(*args)):
            raise AssertionError(f"db_epilogue differs from its plain version at B = {b}")
        nbytes = epilogue_bytes(tuple(x.shape), x.element_size(), 2)
        points.append({"batch": b, "bytes": nbytes,
                       "ms": device_ms(lambda: db_pack.db_epilogue(*args)),
                       "bound_ms": bound_ms(nbytes)})
    fixed, rate = fit_line([(p["bytes"], p["ms"]) for p in points])
    # the same timer on a one-element fill: the cost of any launch in a graph
    one = torch.zeros(1, device="cuda")
    return {"points": points, "fixed_ms": fixed, "bytes_per_s": rate,
            "of_hbm": rate / HBM_BYTES_PER_S, "launch_floor_ms": device_ms(one.zero_)}


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=30, check=True,
    ).stdout.strip().splitlines()[0]


def main(argv: list[str] | None = None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=str(REPO), help="checkout to import the port from")
    ap.add_argument("--label", default="", help="label of the JSON line")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("epilogue_probe needs a CUDA card")
    root = Path(args.root).resolve()
    sys.path.insert(0, str(root))
    from retto_tpu_torch import kernels
    from retto_tpu_torch.ops import db_pack

    if not Path(db_pack.__file__).resolve().is_relative_to(root):
        raise SystemExit(f"imported {db_pack.__file__}, not from {root}")
    print(card_line(), flush=True)
    t = time.perf_counter()
    kernels.load()
    build_s = time.perf_counter() - t
    regs = ptxas_resources(kernels.build_log())
    for name, r in sorted(regs.items()):
        print(f"{name}: {r}", flush=True)
    gen = torch.Generator(device="cuda").manual_seed(0)
    main_x = (torch.randn((MAIN_BATCH, *MAIN_HW), generator=gen, device="cuda") * 3
              ).to(torch.bfloat16)
    probs = torch.sigmoid(torch.randn(ONNX_SHAPE, generator=gen, device="cuda") * 3 - 3)
    modes = {
        "main": (db_pack.db_epilogue, db_pack.db_epilogue_plain,
                 (main_x, LOGIT_THRESH, True, 2, True), 2),
        "mask_only": (db_pack.binarize_dilate_pack_rows_batch,
                      db_pack.binarize_dilate_pack_rows_batch_plain,
                      (main_x, LOGIT_THRESH, True), None),
        "onnx": (db_pack.db_epilogue, db_pack.db_epilogue_plain,
                 (probs, 0.3, True, 4, False), 4),
        "one_map": (db_pack.binarize_dilate_pack_rows,
                    lambda p, *a: db_pack.binarize_dilate_pack_rows_batch_plain(p[None], *a)[0],
                    (main_x[0], LOGIT_THRESH, True), None),
    }
    out = {"label": args.label, "root": str(root), "card": card_line(), "build_s": build_s,
           "ptxas": regs}
    for name, (fn, plain, a, pool) in modes.items():
        got = fn(*a)
        torch.cuda.synchronize()
        if not _exact(got, plain(*a)):
            raise AssertionError(f"{name}: the kernel differs from its plain version")
        x = a[0]
        nbytes = epilogue_bytes(tuple(x.shape) if x.dim() == 3 else (1, *x.shape),
                                x.element_size(), pool)
        out[name] = {"shape": list(x.shape), "ms": device_ms(lambda: fn(*a)),
                     "host_ms": host_ms(lambda: fn(*a)), "bytes": nbytes,
                     "bound_ms": bound_ms(nbytes)}
        print(f"{name} {tuple(x.shape)}: {out[name]['ms']:.6f} ms "
              f"(bound {out[name]['bound_ms']:.6f}, host {out[name]['host_ms']:.6f})", flush=True)
    out["sweep"] = batch_sweep(db_pack, gen)
    for p in out["sweep"]["points"]:
        print(f"main B={p['batch']}: {p['ms']:.6f} ms, {p['bytes']} B "
              f"(bound {p['bound_ms']:.6f})", flush=True)
    print(f"fit: fixed {out['sweep']['fixed_ms']:.6f} ms per launch, "
          f"{out['sweep']['bytes_per_s'] / 1e12:.4f} TB/s "
          f"({out['sweep']['of_hbm']:.3f} of 3.35 TB/s); a one-element fill "
          f"{out['sweep']['launch_floor_ms']:.6f} ms", flush=True)
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
