"""Which cuDNN kernels the port's det forward runs on one CUDA card, under
TF32 and in full float32, and what the fixture pages read in that run.

    python3 tools/cudnn_probe.py [--f32]

One process is one run: it builds ``RettoSession(device="cuda")`` with the
mobile checkpoints (``transfer_format="yuv420"``), runs the 8 gray fixture
pages (``retto_tpu_torch/testdata/smoke_pages.npz``) once, which captures
the graphs, and prints one JSON line: the card, the mode, the lines of
that run agreeing with the JAX pipeline's stored lines
(``chip_smoke.compare``), the texts the port read on page 3, the det
forward's device time at the 16-page call's chunk shape (4 x 1024 x 768,
CUDA events around 20 calls), and the device kernels whose names mark a
convolution or a GEMM, with their counts, from ``torch.profiler`` over a
second run (graph replays) and over one eager det forward at that
shape.

``--f32`` replaces ``models.common._tf32_convs`` with a no-op for this
process, so the convs that feed a BatchNorm run in full float32 instead of
TF32; nothing in the package changes.  Run it several times in each mode
in one call (processes alternate, so each run picks its algorithms anew):

    for i in 1 2 3 4 5; do python3 tools/cudnn_probe.py; python3 tools/cudnn_probe.py --f32; done
"""

from __future__ import annotations

import argparse
import contextlib
import importlib.util
import json
import subprocess
import sys
from collections import Counter
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

CONV_MARKS = ("conv", "cudnn", "xmma", "implicit", "gemm", "fprop", "nchw", "nhwc")


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _det_forward_ms(dp, iters: int = 20) -> float:
    model = dp._det_model
    x = torch.randn((4, 1024, 768, 3), device="cuda").to(model.compute_dtype or torch.float32)
    with torch.inference_mode():
        for _ in range(10):
            model(x, nhwc=True, raw_logits=True)
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            model(x, nhwc=True, raw_logits=True)
        end.record()
        torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--f32", action="store_true",
                    help="full float32 for the BatchNorm convs (no TF32)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("needs a CUDA card")
    from retto_tpu_torch import RettoSession, SessionConfig
    from retto_tpu_torch.models import common
    from retto_tpu_torch.ops.charset import CharacterDict

    if args.f32:
        common._tf32_convs = lambda x: contextlib.nullcontext()
    chip_smoke = _chip_smoke()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=30, check=True).stdout.strip()
    fx = np.load(ROOT / "retto_tpu_torch" / "testdata" / "smoke_pages.npz")
    chars = CharacterDict((ROOT / "trained_weights" / "charset.txt").read_text().splitlines())
    cfg = SessionConfig()
    cfg.engine.transfer_format = "yuv420"
    with RettoSession(cfg, charset=chars, weights={
        k: str(ROOT / "trained_weights" / f"{k}.npz") for k in ("det", "cls", "rec")
    }, device="cuda") as session:
        dp = session.device_pipeline()
        pages = [np.repeat(p[..., None], 3, axis=2) for p in fx["pages"]]
        res = dp.run_many(pages)  # captures the graphs
        lines = chip_smoke._lines(res, range(len(pages)))
        agree, total, _ = chip_smoke.compare("gray", lines, fx["jax_page"], fx["jax_boxes"],
                                             fx["jax_texts"])
        x = torch.randn((4, 1024, 768, 3), device="cuda").to(dp._det_model.compute_dtype)
        acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
        kernels = {}
        for label, fn in (("replayed", lambda: dp.run_many(pages)),
                          ("eager_det_forward", lambda: dp._det_model(x, nhwc=True,
                                                                      raw_logits=True))):
            with torch.inference_mode(), torch.profiler.profile(activities=acts) as prof:
                fn()
                torch.cuda.synchronize()
            kernels[label] = dict(sorted(Counter(
                ev.name for ev in prof.events()
                if ev.device_type == torch.autograd.DeviceType.CUDA
                and any(m in ev.name.lower() for m in CONV_MARKS)).items()))
        det_ms = _det_forward_ms(dp)
    print(json.dumps({
        "card": smi,
        "mode": "f32" if args.f32 else "tf32",
        "lines_agreeing_with_jax": f"{agree}/{total}",
        "page3_texts": [t for p, _, t in lines if p == 3],
        "det_forward_ms": det_ms,
        "conv_kernels": kernels,
    }), flush=True)


if __name__ == "__main__":
    main()
