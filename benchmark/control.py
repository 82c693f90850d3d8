"""Readings for the limits of a cell's compared numbers: the program over
many seeds, the program with a planted fault and the fp8 control over a
few, in one process.

    python3 -m benchmark.control --workload <cell> --seeds 1-12 --fault-seeds 201-203 \\
        --control-seeds 101-103 [--seconds 2]

For each program seed the cell's pages are made, warmed up and driven for
``--seconds`` as a run drives them, and what was served is judged against
the float32 reference; each fault seed does the same with
:func:`empty_half` planted under ``run_many``; for each control seed the
reference in fp8, put in the program's place, answers the same pages and is
judged alike.  One JSON line a seed: the numbers and the worst case behind
each.  Limits are set
from these readings (``benchmark/limits/<cell>.json``); the benchmark's own
runs never run the control.
"""

from __future__ import annotations

import argparse
import json
import sys

import torch

from benchmark import run as R


def _seeds(text: str) -> list[int]:
    out = []
    for part in text.split(","):
        if "-" in part:
            a, b = part.split("-")
            out.extend(range(int(a), int(b) + 1))
        elif part:
            out.append(int(part))
    return out


def empty_half(dp) -> None:
    """A planted fault: ``run_many`` serves the first half of each batch
    and answers the rest as pages without a line."""
    from retto_tpu_torch.results import ClsResult, DetResult, OcrResult, RecResult

    orig = dp.run_many

    def run_many(inputs, *a, **k):
        keep = len(inputs) // 2 or 1
        return orig(inputs[:keep], *a, **k) + [
            OcrResult(DetResult(), ClsResult(), RecResult()) for _ in inputs[keep:]]
    dp.run_many = run_many


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", default="")
    ap.add_argument("--fault-seeds", default="")
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--seconds", type=float, default=2.0)
    args = ap.parse_args(argv)
    R.cache_env(R.ROOT)
    if not torch.cuda.is_available():
        raise R.Refused("needs a CUDA card")
    from benchmark.reference.ocr import Reference, judge
    from benchmark.traffic.pages import make_pool

    spec = R.load_cell(args.workload)
    cfg, mix = spec["config"], spec["mix"]
    dev = torch.device("cuda")
    session, dp = R.build_program(cfg, "cuda")
    torch.backends.cudnn.allow_tf32 = False
    ref = Reference(cfg, R.ROOT, dev)
    for seed in _seeds(args.seeds):
        pool = make_pool(mix, seed)
        run = R.drive_closed(dp, mix, pool, args.seconds, False, True, seed)
        nums, worst = _judge_closed(ref, run, seed, judge)
        print(json.dumps({"seed": seed, "side": "program", **nums, "worst": worst}), flush=True)
    if args.fault_seeds:
        empty_half(dp)
    for seed in _seeds(args.fault_seeds):
        pool = make_pool(mix, seed)
        run = R.drive_closed(dp, mix, pool, args.seconds, False, True, seed)
        nums, _ = _judge_closed(ref, run, seed, judge)
        print(json.dumps({"seed": seed, "side": "empty_half", **nums}), flush=True)
    session.close()
    del session, dp
    ctl = Reference(cfg, R.ROOT, dev, precision="fp8")
    for seed in _seeds(args.control_seeds):
        pool = make_pool(mix, seed)
        worst = {}
        nums = judge(ref, pool, ctl.answer(pool), explain=worst)
        print(json.dumps({"seed": seed, "side": "control", **nums, "worst": worst}), flush=True)


def _judge_closed(ref, run, seed, judge):
    worst = {}

    def explained(r, pages, answers):
        return judge(r, pages, answers, explain=worst)

    return R.judge_closed(ref, run, seed, judge_fn=explained), worst


if __name__ == "__main__":
    main(sys.argv[1:])
