"""Where the time goes in the port's fused pipeline on one CUDA card.

Builds ``retto_tpu_torch.RettoSession`` on ``cuda`` with the mobile
checkpoints (``transfer_format="yuv420"``), or with ``--onnx`` the ONNX
path (``chip_smoke.py``'s ``onnx_session``: ``OnnxEngine`` over the three
Paddle-export replicas), warms it, then runs the bench.py config-3
workload (16 gray 960x704 fixture pages, each fixture page twice) under
``torch.profiler`` and prints one JSON line:

* ``wall_ms``: host clock around one ``run_many`` ending in a synchronize;
* ``device_busy_ms``: the union of the CUDA kernel and memcpy intervals in
  that window, and ``device_idle_share`` = 1 - busy / wall;
* ``kernels``: the top device-time entries of ``key_averages()``;
* ``device_ms_by_kind``: the call's device time and event count by kind of
  kernel, from the kernel names (``_KINDS``);
* ``host_phases``: the pipeline's own ``last_stats`` (seconds);
* ``compile_count``: the graphs the pipeline captured (null for a tree
  that dispatches eagerly);
* ``det_epilogue``: the ``db_epilogue`` kernels in that call, the count of
  the wrapper and of the traced kernels, and their device time;
* ``det_forward_ms``: the det model's forward alone at the 16-page call's
  chunk shape (4 x 1024 x 768: NHWC in the compute dtype, or NCHW float32
  for an ONNX det), device time from CUDA events around 20 calls after 10
  warm-up calls;
* ``epilogue_alone`` and ``mask_kernel_alone``: the det epilogue as
  ``_det_fwd``'s aligned branch runs it (``db_epilogue``) and its
  mask-only mode, on seeded [4, 512, 384] bf16 logits (``--onnx``: [4,
  1024, 768] float32 probabilities, pool 4): device time per call from a
  CUDA graph and host time per call, with ``chip_smoke.py``'s
  ``device_ms`` and ``host_ms``;
* ``lines_agreeing_with_jax``: the 8 fixture pages of the call against the
  JAX pipeline's stored lines (``--onnx``: the JAX ``OnnxEngine``'s,
  ``testdata/smoke_onnx.npz``), counted by ``chip_smoke.py``'s ``compare``.

The Chrome trace goes to ``chiprun_out/torch_pipeline_trace<suffix>.json``.

    python3 tools/profile_torch_pipeline.py [--onnx] [--root CHECKOUT] [--label NAME]

``--root`` imports ``retto_tpu_torch`` from another checkout (for example
the parent commit unpacked by ``git archive``), so that two trees are
measured in one call on one card; that tree must have ``db_epilogue``.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent.parent


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


# (kind, name fragments), first match wins; matched case-insensitively
_KINDS = (
    ("db_epilogue", ("db_epilogue",)),
    ("memcpy_memset", ("memcpy", "memset")),
    ("cudnn_layout", ("nchwtonhwc", "nhwctonchw")),
    ("conv", ("xmma", "implicit_gemm", "conv")),
    ("gemm", ("gemm", "nvjet", "cutlass")),
    ("copy_cast", ("copy",)),
    ("elementwise", ("elementwise",)),
    ("reduce", ("reduce",)),
)


def _by_kind(events: list) -> dict:
    """{kind: {"device_ms", "count"}} over the call's device events."""
    out: dict = {}
    for e in events:
        name = e.name.lower()
        kind = next((k for k, marks in _KINDS if any(m in name for m in marks)), "other")
        d = out.setdefault(kind, {"device_ms": 0.0, "count": 0})
        d["device_ms"] += (e.time_range.end - e.time_range.start) / 1e3
        d["count"] += 1
    return dict(sorted(out.items(), key=lambda kv: -kv[1]["device_ms"]))


def _epilogue(events: list) -> tuple[int, float]:
    """(kernels, device ms) of the det epilogue among the call's device
    events."""
    fused = [e for e in events if "db_epilogue" in e.name]
    return len(fused), sum(e.time_range.end - e.time_range.start for e in fused) / 1e3


def _det_forward_ms(dp, iters: int = 20) -> float:
    model = dp._det_model
    if getattr(dp, "_det_native", True):
        dt = getattr(model, "compute_dtype", None) or torch.float32
        x = torch.randn((4, 1024, 768, 3), device="cuda").to(dt)

        def fwd():
            return model(x, nhwc=True, raw_logits=True)
    else:  # a translated ONNX det: NCHW float32 in
        x = torch.randn((4, 3, 1024, 768), device="cuda")

        def fwd():
            return model(x)
    with torch.inference_mode():
        for _ in range(10):
            fwd()
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fwd()
        end.record()
        torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def _chip_smoke():
    """This checkout's chip_smoke.py, loaded after the port so that its own
    imports find the tree chosen by --root already imported."""
    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    chip_smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(chip_smoke)
    return chip_smoke


def _epilogue_alone(chip_smoke, db_pack, onnx: bool) -> dict:
    gen = torch.Generator(device="cuda").manual_seed(0)
    if onnx:  # float32 probabilities at full resolution, pool 4
        pred = torch.sigmoid(torch.randn(chip_smoke.ONNX_SHAPE, generator=gen,
                                         device="cuda") * 3 - 3)
        t, pool, logits = 0.3, 4, False
    else:
        pred = (torch.randn(chip_smoke.MAIN_SHAPE, generator=gen, device="cuda") * 3).to(
            torch.bfloat16)
        t, pool, logits = chip_smoke.LOGIT_THRESH, 2, True

    def mask():
        return db_pack.binarize_dilate_pack_rows_batch(pred, t, True)

    def epilogue():
        return db_pack.db_epilogue(pred, t, True, pool, logits)

    return {name: {"device_ms": chip_smoke.device_ms(fn), "host_ms": chip_smoke.host_ms(fn)}
            for name, fn in (("epilogue_alone", epilogue), ("mask_kernel_alone", mask))}


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--root", default=str(ROOT), help="checkout to import the port from")
    ap.add_argument("--label", default="", help="suffix of the trace file and label of the line")
    ap.add_argument("--onnx", action="store_true",
                    help="the ONNX path: chip_smoke.py's replica OnnxEngine session")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("needs a CUDA card")
    sys.path.insert(0, str(Path(args.root).resolve()))
    from retto_tpu_torch import RettoSession, SessionConfig
    from retto_tpu_torch.ops import db_pack
    from retto_tpu_torch.ops.charset import CharacterDict

    chip_smoke = _chip_smoke()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=30, check=True).stdout.strip()
    fx = np.load(ROOT / "retto_tpu_torch" / "testdata" / "smoke_pages.npz")
    if args.onnx:
        dp = chip_smoke.onnx_session().device_pipeline()
        ref = np.load(ROOT / "retto_tpu_torch" / "testdata" / "smoke_onnx.npz")
        keep = ref["fused_page"] < 8
        ref_lines = (ref["fused_page"][keep], ref["fused_boxes"][keep], ref["fused_texts"][keep])
    else:
        chars = CharacterDict((ROOT / "trained_weights" / "charset.txt").read_text().splitlines())
        cfg = SessionConfig()
        cfg.engine.transfer_format = "yuv420"
        dp = RettoSession(cfg, charset=chars, weights={
            k: str(ROOT / "trained_weights" / f"{k}.npz") for k in ("det", "cls", "rec")
        }, device="cuda").device_pipeline()
        ref_lines = (fx["jax_page"], fx["jax_boxes"], fx["jax_texts"])
    pages = [np.repeat(p[..., None], 3, axis=2) for p in fx["pages"]] * 2
    for _ in range(2):
        dp.run_many(pages)
    res = dp.run_many(pages)
    agree, total, _ = chip_smoke.compare("gray", chip_smoke._lines(res[:8], range(8)),
                                         *ref_lines)
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        db_pack.db_epilogue.launches = 0
        t0 = time.perf_counter()
        dp.run_many(pages)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    launches = db_pack.db_epilogue.launches
    dev_events = [ev for ev in prof.events()
                  if ev.device_type == torch.autograd.DeviceType.CUDA]
    intervals = [(ev.time_range.start, ev.time_range.end) for ev in dev_events]
    epi_kernels, epi_ms = _epilogue(dev_events)
    det_ms = _det_forward_ms(dp)
    alone = _epilogue_alone(chip_smoke, db_pack, args.onnx)
    busy_ms = _union_ms(intervals)
    rows = []
    for a in prof.key_averages():
        dev_us = getattr(a, "self_device_time_total", 0) or getattr(a, "self_cuda_time_total", 0)
        if dev_us > 0:
            rows.append((dev_us, a.key, a.count))
    rows.sort(reverse=True)
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    suffix = f"_{args.label}" if args.label else ""
    prof.export_chrome_trace(str(out_dir / f"torch_pipeline_trace{suffix}.json"))
    print(json.dumps({
        "label": args.label,
        "path": "onnx" if args.onnx else "mobile",
        "root": str(Path(args.root).resolve()),
        "card": smi,
        "pages": len(pages),
        "wall_ms": wall_ms,
        "images_per_s": len(pages) / wall_ms * 1e3,
        "device_busy_ms": busy_ms,
        "device_idle_share": 1.0 - busy_ms / wall_ms,
        "device_events": len(intervals),
        "det_epilogue": {"counted_launches": launches, "kernels": epi_kernels,
                         "device_ms": epi_ms},
        "lines_agreeing_with_jax": f"{agree}/{total}",
        "det_forward_ms": det_ms,
        **alone,
        "kernels": [{"name": k[:90], "device_ms": us / 1e3, "count": c}
                    for us, k, c in rows[:15]],
        "device_ms_by_kind": _by_kind(dev_events),
        "host_phases": {k: v for k, v in dp.last_stats.items()},
        "compile_count": dp.compile_count() if hasattr(dp, "compile_count") else None,
    }), flush=True)
    if hasattr(dp, "close"):
        dp.close()


if __name__ == "__main__":
    main()
