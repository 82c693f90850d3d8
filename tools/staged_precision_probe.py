"""The staged session's precision on the card: ``TorchEngine`` in full
float32 (as shipped) against the fused path's TF32 BatchNorm convs.

    python3 tools/staged_precision_probe.py [--rounds 2]

Needs a CUDA card.  For each round, each setting and each mode (COMPAT,
PERFORMANCE) it builds a session over the mobile checkpoints, runs the 10
fixture inputs of ``chip_smoke.py`` once (printing the lines that differ
from the JAX staged session, ``testdata/smoke_staged.npz``), then times 3
warm passes; one line per run: lines agreeing, the largest box distance
and images/s (median of the 3 passes).  The settings alternate inside one
process, so both meet the same card and host.
"""

from __future__ import annotations

import argparse
import contextlib
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402
from retto_tpu_torch.pipeline import engine as engine_mod  # noqa: E402


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rounds", type=int, default=2)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("needs a CUDA card")
    fx = np.load(ROOT / "retto_tpu_torch" / "testdata" / "smoke_pages.npz")
    ref = np.load(ROOT / "retto_tpu_torch" / "testdata" / "smoke_staged.npz")
    inputs = cs.fixture_inputs(fx)
    shipped = engine_mod.full_float32
    settings = {"float32": shipped, "tf32": contextlib.nullcontext}
    for rnd in range(args.rounds):
        for label, ctx in settings.items():
            engine_mod.full_float32 = ctx
            for mode in ("compat", "performance"):
                with cs.mobile_session(mode) as session:
                    res = [session.run(x) for x in inputs]
                    torch.cuda.synchronize()
                    agree, total, dists = cs.compare(
                        f"{label}-{mode}", cs._lines(res, range(len(inputs))),
                        ref[f"{mode}_page"], ref[f"{mode}_boxes"], ref[f"{mode}_texts"])
                    times = []
                    for _ in range(3):
                        t = time.perf_counter()
                        for x in inputs:
                            session.run(x)
                        torch.cuda.synchronize()
                        times.append(time.perf_counter() - t)
                print(f"round {rnd} {label} {mode}: agree {agree}/{total} "
                      f"box_max {max(dists, default=0.0):.2f} images/s median "
                      f"{len(inputs) / sorted(times)[1]:.3f} passes "
                      f"{[round(x, 4) for x in times]}", flush=True)
    engine_mod.full_float32 = shipped


if __name__ == "__main__":
    main()
