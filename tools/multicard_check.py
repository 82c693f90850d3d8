"""The port's data and tensor parallelism across several cards of one host.

Two checks that need more than one card (``chip_smoke.py`` phase parallel
covers one card):

1. inference: ``RettoSession(mesh=make_mesh())`` over every card, the fused
   ``run_many`` on the fixture inputs against the mesh-free session on
   ``cuda:0`` by ``chip_smoke.py``'s stream rule (equal box counts, boxes
   within 0.5 px, at least 99% of the texts equal), the det epilogue once
   per shard of each det chunk (the image tensor crosses cards by peer
   copies), and warm 16-page calls timed mesh-free, mesh, mesh, mesh-free
   (images/s of each);
2. training: one process per card (``--ranks``, as ``torchrun
   --nproc_per_node``) over NCCL, ``global_mesh(model_parallel=2)``,
   ``STEPS`` steps of the big-vocab rec from ``rec_big.npz`` in float32
   (no TF32) with ``{"Dense_1": P(None, "model")}`` (the 6,625-class head
   split 3,313 + 3,312) on the fixture's 16 rec lines, against the same
   steps unsharded on one card: each loss within ``LOSS_RTOL``, each
   first-step gradient (after the 'data' average) within ``GRAD_RTOL`` of
   its norm, and after the steps each parameter within ``PARAM_RTOL`` of
   the norm of its change, for the tensors whose first-step gradient is at
   least 1% of the largest (below it the gradient is roundoff).  Adam's
   first steps move each weight by about the rate in its gradient's sign,
   so a weight whose gradient is near 0 moves either way under another sum
   order: the parameters agree less closely than the gradients.

Prints one ``[multicard]`` line per result and, last, one JSON line.

    python3 tools/multicard_check.py [--device cuda|cpu] [--ranks N] [--pages N]

``--device cpu`` rehearses both checks on the CPU: a mesh that names the
CPU ``--ranks`` times, and gloo ranks.
"""

from __future__ import annotations

import argparse
import json
import os
import socket
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402
from retto_tpu_torch import PipelineMode, RettoSession, SessionConfig  # noqa: E402
from retto_tpu_torch._build import BUILD_DIR  # noqa: E402
from retto_tpu_torch.models import build_rec  # noqa: E402
from retto_tpu_torch.ops import db_pack  # noqa: E402
from retto_tpu_torch.ops.charset import CharacterDict  # noqa: E402
from retto_tpu_torch.parallel import distributed, make_mesh  # noqa: E402
from retto_tpu_torch.parallel.mesh import P  # noqa: E402
from retto_tpu_torch.train import ctc_loss, init_train_state, make_train_step  # noqa: E402
from retto_tpu_torch.train.data import gather_rec_batch  # noqa: E402
from retto_tpu_torch.weights import (  # noqa: E402
    export_flax_params, load_flax_params, load_params_meta,
)

STEPS = 3
LR = 1e-4
LOSS_RTOL = 1e-4
GRAD_RTOL = 1e-4
PARAM_RTOL = 2e-2
RULES = {"Dense_1": P(None, "model")}


def session(device: str, mesh=None) -> RettoSession:
    wd = ROOT / "trained_weights"
    chars = CharacterDict((wd / "charset.txt").read_text().splitlines())
    weights = {k: str(wd / f"{k}.npz") for k in ("det", "cls", "rec")}
    cfg = SessionConfig(mode=PipelineMode("performance"))
    if mesh is not None:
        return RettoSession(cfg, preset="mobile", charset=chars, weights=weights, mesh=mesh)
    return RettoSession(cfg, preset="mobile", charset=chars, weights=weights, device=device)


def _sync(device: str) -> None:
    if device == "cuda":
        torch.cuda.synchronize()


def inference_check(device: str, ranks: int, pages: int) -> dict:
    fx = np.load(ROOT / "retto_tpu_torch" / "testdata" / "smoke_pages.npz")
    inputs = cs.fixture_inputs(fx)[:pages]
    devices = ([torch.device("cuda", i) for i in range(torch.cuda.device_count())]
               if device == "cuda" else [torch.device("cpu")] * ranks)
    mesh = make_mesh(devices=devices)
    with session(device) as single, session(device, mesh) as sharded:
        free, dp = single.device_pipeline(), sharded.device_pipeline()
        ref = free.run_many(inputs)
        db_pack.db_epilogue.launches = 0
        got = dp.run_many(inputs)
        _sync(device)
        first = db_pack.db_epilogue.launches
        db_pack.db_epilogue.launches = 0
        dp.run_many(inputs)
        _sync(device)
        warm, chunks = db_pack.db_epilogue.launches, dp.last_stats["chunks"]
        lines, equal, box_max = cs.same_results("mesh vs mesh-free", ref, got)
        out = {"cards": len(devices), "shards": mesh.shape["data"], "lines": lines,
               "texts_equal": equal, "box_max_px": box_max, "first_call_launches": first,
               "warm_call_launches": warm, "chunks": chunks}
        cs.say("multicard", **out)
        if box_max > cs.STREAM_BOX_PX or not lines or equal / lines < cs.STREAM_TEXT_MIN:
            cs.fail(f"mesh: {equal}/{lines} texts, boxes within {box_max:.2f} px")
        if device == "cuda" and warm != mesh.shape["data"] * chunks:
            cs.fail(f"mesh: {warm} det epilogue launches for {chunks} chunks")
        batch = (inputs[:8] * 2)[:16]
        for p in (free, dp):
            p.run_many(batch)
        _sync(device)
        compiles = dp.compile_count() + free.compile_count()
        times: dict[str, list[float]] = {"mesh_free": [], "mesh": []}
        for label in ("mesh_free", "mesh", "mesh", "mesh_free") * 2:
            p = dp if label == "mesh" else free
            t = time.perf_counter()
            p.run_many(batch)
            _sync(device)
            times[label].append(time.perf_counter() - t)
        rates = {k: [round(len(batch) / x, 3) for x in v] for k, v in times.items()}
        cs.say("multicard", pages=len(batch), images_per_s=json.dumps(rates),
               captures_in_timed_region=dp.compile_count() + free.compile_count() - compiles)
        out["images_per_s"] = rates
    return out


def _rec_batch(device):
    fx = np.load(ROOT / "retto_tpu_torch" / "testdata" / "smoke_train.npz")
    data = cs.train_data("rec", fx, device)
    return gather_rec_batch(data, torch.arange(len(data.lines), device=device))


def _rec_steps(device, mesh=None) -> tuple[list[float], dict, dict]:
    torch.backends.cudnn.allow_tf32 = False
    flat, _ = load_params_meta(ROOT / "trained_weights" / "rec_big.npz")
    model = load_flax_params(build_rec("mobile", num_classes=6625, compute_dtype=None), flat)
    state = init_train_state(model, LR, device=None if mesh is not None else device,
                             mesh=mesh, rules=RULES if mesh is not None else None)
    step = make_train_step(model, ctc_loss, forward=lambda m, v: m(v, return_logits=True),
                           mesh=mesh)
    batch = _rec_batch(next(model.parameters()).device)
    losses, grads = [], {}
    for i in range(STEPS):
        state, loss = step(state, *batch)
        losses.append(float(loss))
        if i == 0:  # the first-step gradients, in Flax's layout
            with torch.no_grad():
                saved = [p.detach().clone() for p in model.parameters()]
                for p in model.parameters():
                    p.copy_(p.grad)
                grads = export_flax_params(model)
                for p, v in zip(model.parameters(), saved):
                    p.copy_(v)
    return losses, export_flax_params(model), grads


def worker(rank: int, ranks: int, addr: str, device: str, out: Path) -> None:
    distributed.initialize(addr, ranks, rank, device=device, timeout_s=300)
    mesh = distributed.global_mesh(model_parallel=2)
    losses, params, grads = _rec_steps(device, mesh)
    np.savez(out / f"rank{rank}.npz", losses=np.asarray(losses),
             data_index=mesh.get_local_rank("data"), model_index=mesh.get_local_rank("model"),
             **{f"p:{k}": v for k, v in params.items()},
             **{f"g:{k}": v for k, v in grads.items()})
    torch.distributed.destroy_process_group()


def training_check(device: str, ranks: int) -> dict:
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        procs = []
        t = time.perf_counter()
        for r in range(ranks):
            env = dict(os.environ, LOCAL_RANK=str(r), OMP_NUM_THREADS="2")
            procs.append(subprocess.Popen(
                [sys.executable, __file__, "--worker", str(r), "--ranks", str(ranks),
                 "--addr", f"127.0.0.1:{port}", "--device", device, "--out", tmp],
                env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
        try:
            outs = [p.communicate(timeout=600) for p in procs]
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.communicate()
        for p, (_, err) in zip(procs, outs):
            if p.returncode != 0:
                cs.fail(f"a training rank exited {p.returncode}: {err[-2000:]}")
        wall = time.perf_counter() - t
        ranks_out = [dict(np.load(Path(tmp) / f"rank{r}.npz")) for r in range(ranks)]
    ref_losses, ref, grads = _rec_steps("cuda:0" if device == "cuda" else "cpu")
    flat, _ = load_params_meta(ROOT / "trained_weights" / "rec_big.npz")
    start = export_flax_params(load_flax_params(
        build_rec("mobile", num_classes=6625, compute_dtype=None), flat))
    by = {(int(r["data_index"]), int(r["model_index"])): r for r in ranks_out}
    loss_rel = max(abs(a - b) / abs(b) for r in ranks_out for a, b in zip(r["losses"], ref_losses))
    def joined(tag: str, k: str) -> np.ndarray:
        parts = [by[0, m][f"{tag}:{k}"] for m in range(2)]
        split = k.startswith("params::") and k.endswith("Dense_1::kernel")
        return np.concatenate(parts, axis=-1) if split else parts[0]

    mine = {k: joined("p", k) for k in ref}
    gnorm = {k: float(np.linalg.norm(v)) for k, v in grads.items() if k.startswith("params::")}
    floor = 1e-2 * max(gnorm.values())
    kept = [k for k, g in gnorm.items() if g >= floor]
    grad_rel = max(float(np.linalg.norm(joined("g", k) - grads[k])) / gnorm[k] for k in kept)
    param_rel = max(float(np.linalg.norm(mine[k] - ref[k]) / np.linalg.norm(ref[k] - start[k]))
                    for k in kept)
    head = [by[0, m]["p:params::Dense_1::kernel"].shape[-1] for m in range(2)]
    out = {"ranks": ranks, "mesh": [ranks // 2, 2], "head_split": head,
           "sharded_losses": [round(float(v), 6) for v in ranks_out[0]["losses"]],
           "unsharded_losses": [round(v, 6) for v in ref_losses], "loss_rel_diff": loss_rel,
           "grad_rel_diff": grad_rel, "param_change_rel_diff": param_rel,
           "ranks_wall_s": round(wall, 1)}
    cs.say("multicard", **out)
    if loss_rel > LOSS_RTOL or grad_rel > GRAD_RTOL or param_rel > PARAM_RTOL:
        cs.fail("the sharded step across cards differs from the unsharded step")
    return out


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--ranks", type=int, default=None,
                    help="training ranks (default: every card; 4 on the CPU)")
    ap.add_argument("--pages", type=int, default=10, help="fixture inputs for inference")
    ap.add_argument("--worker", type=int, default=None, help=argparse.SUPPRESS)
    ap.add_argument("--addr", default=None, help=argparse.SUPPRESS)
    ap.add_argument("--out", type=Path, default=None, help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.device == "cuda" and not torch.cuda.is_available():
        cs.fail("no CUDA device (pass --device cpu to rehearse on the CPU)")
    ranks = args.ranks or (torch.cuda.device_count() if args.device == "cuda" else 4)
    if args.worker is not None:
        worker(args.worker, ranks, args.addr, args.device, args.out)
        return
    if args.device == "cuda":
        print(cs.card()[0], flush=True)
        cs.build()
    res = {"inference": inference_check(args.device, ranks, args.pages),
           "training": training_check(args.device, ranks)}
    print(json.dumps(res), flush=True)


if __name__ == "__main__":
    main()
