"""Chip smoke test of the PyTorch/CUDA port (retto_tpu_torch) on one GPU.

Run from the repository root on a machine with a CUDA card:

    python3 chip_smoke.py

Phases, one line each as they finish (a cut run shows where it stopped):

0. the card: ``nvidia-smi`` name and power limit, torch and CUDA versions;
1. build: the CUDA kernel library (nvcc) and the C++ postprocess (g++),
   started together, with their seconds;
2. kernel vs plain: ``ops.db_pack.db_epilogue`` (the det epilogue: mask and
   pooled prob map in one launch) on the card against its plain PyTorch
   version ``db_epilogue_plain`` on the same inputs, both outputs bit-exact
   (``torch.equal``), and the mask-only entry points likewise; then timed at
   the main path's shape: device time per launch from a CUDA graph of 100
   launches, host time per wrapper call, beside its memory bound; and the
   same, bit-exact first, at the ONNX path's shape (``ONNX_SHAPE``: float32
   probabilities at full resolution, pool 4);
3. end to end: ``RettoSession(device="cuda").device_pipeline().run_many``
   with the mobile checkpoints over the fixture pages
   (``retto_tpu_torch/testdata/smoke_pages.npz``: gray pages, one tinted
   page, one tinted and rotated page that takes the gather warp and the
   cls flip, one run with ``transfer_format="rgb"``), held to the JAX
   pipeline's texts and boxes stored in the fixture; the kernel's launch
   count is read around the run (and the mask-only mode must not run; the
   det forward and each cls + rec bucket run as captured CUDA graphs, and
   the count includes the launches their replays make); every graph call
   of that run is held bit for bit against the eager function on the
   same inputs (det: packed mask, prob map, image tensor; cls + rec: cls
   probabilities, flips, CTC indices, keep mask, scores); then warm
   16-page runs are timed, with no capture allowed inside the timing;
4. stream: mixed-size pages (bench.py config 5's sizes, made from the
   fixture pages) in 2 batches of 12, streamed 3 times, against
   ``run_many`` per batch (same box counts, boxes within 0.5 px, at least
   99% of the texts equal); the cross-shape pad + concat must run and the
   timed pass must capture nothing; images/s and rec bucket occupancy;
5. staged: ``RettoSession(device="cuda").run`` (``TorchEngine`` and the
   three stages) in COMPAT and PERFORMANCE mode on the 10 fixture inputs,
   held to the JAX staged session's lines
   (``retto_tpu_torch/testdata/smoke_staged.npz``) by the same rule as
   the fused path; ``run_stream`` (det, cls, rec, equal to ``run``) and
   ``run_many`` (a corrupt input isolated); ``engine.compiled_shapes()``;
   images/s (median of 3 warm passes) and ms per image per stage; then one
   staged pass and one fused ``run_many`` from two threads at once, which
   must give their single-thread texts;
6. cli: ``python3 -m retto_tpu_torch.cli ocr`` in subprocesses on the
   fixture inputs written as PNGs (a standard-library encoder), staged and
   with ``--device-pipeline``, must read the session's texts; ``info``
   must name the card;
7. serve: ``serve.make_server`` on port 0 with a PERFORMANCE session: 8
   concurrent ``/ocr`` POSTs (texts of ``run_many``, the kernel launched
   from the batcher thread, latency p50 and max), ``/ocr/stream`` (det,
   cls, rec), ``/metrics`` (``avg_batch`` > 1), ``/healthz``; then a COMPAT
   session serves ``/ocr`` through the staged path; ``server_close()`` and
   ``close()`` must return within ``SERVER_CLOSE_S``;
8. presets: the server preset (``det_server.npz``, ``rec_server.npz``,
   ``cls.npz``) through the fused ``run_many`` on the 8 gray fixture pages,
   and the big-vocab rec alone (``rec_big.npz``, ``charset_big.txt``, 6,625
   classes) on 16 crops at 48x320, each held to its JAX fixture
   (``retto_tpu_torch/testdata/smoke_presets.npz``) by the line rule of
   phase 3;
9. train: from each shipped mobile checkpoint (float32 master weights,
   bf16 compute) three steps of the tool's AdamW schedule on the fixture
   batches (``retto_tpu_torch/testdata/smoke_train.npz``: 16 rec lines at
   48x512, 16 cls crops in two views, 2 det pages at 512x512 whose DB maps
   ``train.data.db_gt_device`` draws from their boxes), the losses held to
   the JAX trainer's within ``TRAIN_LOSS_TOL``, every loss and gradient
   finite; ``CheckpointManager`` save and restore and a ``save_params``
   export that reloads into the port with equal outputs; then warm steps
   timed at the tool's batch sizes (rec 128, cls 128 in two views, det 8),
   steps/s per target, median and spread.  The synthetic trainer
   (``python -m retto_tpu_torch.train.synthetic``) is not run: its
   renderers need the DejaVu fonts, which the H100 host checked for this
   script lacks;
10. onnx: the ONNX path, ``OnnxEngine(device="cuda")`` over the three
   full-size Paddle-export replicas (``weights/replica.py``, 6,625-class
   rec, ``charset_big.txt``): the fused ``run_many`` on the 8 gray pages and
   the rotated page, which launches the det epilogue in its float32
   probability, pool-4 mode (asserted per call) on [4, 1024, 768] maps,
   its graph calls against eager bit for bit, and the staged COMPAT
   ``run`` on the 10 fixture inputs, both held to the JAX ``OnnxEngine``'s
   lines (``retto_tpu_torch/testdata/smoke_onnx.npz``) by phase 3's rule
   with at least one box on every page; images/s of warm 16-page calls,
   no capture inside them.  Phase 2 times the kernel at that shape;
11. a JSON line ``{"kernels": [...]}`` and, last, the JSON line
   ``{"ok": true, "device": {...}}``.

``compile_count()`` (captured graphs) is printed after each phase.

Any failure exits non-zero before the last line.  Without a CUDA card, or
without the package beside it, the script exits non-zero and prints no
result.  It imports only the port, torch, numpy, scipy and the standard
library.
"""

from __future__ import annotations

import json
import math
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch
from scipy import ndimage

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT))

from retto_tpu_torch import (  # noqa: E402
    OnnxEngine, PipelineMode, RettoError, RettoSession, SessionConfig,
)
from retto_tpu_torch import kernels, native  # noqa: E402
from retto_tpu_torch._build import BUILD_DIR  # noqa: E402
from retto_tpu_torch.ops import db_pack  # noqa: E402
from retto_tpu_torch.ops.charset import CharacterDict  # noqa: E402
from retto_tpu_torch.models import build_cls, build_det, build_rec  # noqa: E402
from retto_tpu_torch.models.common import cast_compute  # noqa: E402
from retto_tpu_torch.ops.ctc import ctc_greedy_decode  # noqa: E402
from retto_tpu_torch.pipeline import device_pipeline  # noqa: E402
from retto_tpu_torch.pipeline.device_pipeline import _is_aligned  # noqa: E402
from retto_tpu_torch.serve import make_server  # noqa: E402
from retto_tpu_torch.train import (  # noqa: E402
    ctc_loss, db_loss, init_train_state, make_train_step, warmup_cosine_decay,
)
from retto_tpu_torch.train.checkpoint import CheckpointManager  # noqa: E402
from retto_tpu_torch.train.data import (  # noqa: E402
    ClsDeviceData, DetDeviceData, RecDeviceData, gather_cls_batch, gather_det_batch,
    gather_rec_batch,
)
from retto_tpu_torch.train.synthetic import _cls_loss_sym, _cls_views  # noqa: E402
from retto_tpu_torch.weights import (  # noqa: E402
    export_flax_params, load_flax_params, load_params_meta, save_params,
)
from retto_tpu_torch.weights.replica import (  # noqa: E402
    build_cls_replica, build_det_replica, build_rec_replica,
)

HBM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3 (NVIDIA data sheet)
MAIN_SHAPE = (4, 512, 384)  # det chunk 4 x stride-2 logits of a 1024x768 bucket
# the ONNX path's det chunk: 4 x full-resolution float32 probabilities of a
# 1024x768 bucket, pooled by 4 (phase onnx)
ONNX_SHAPE = (4, 1024, 768)
LOGIT_THRESH = math.log(0.3 / 0.7)
# a line agrees with the JAX pipeline when its text is equal and its box
# lies within BOX_TOL_PX; at least TEXT_MATCH_MIN of the lines must agree.
# No box may lie beyond BOX_MAX_PX: one stride-2 mask pixel is ~2 page px,
# and a bf16 mask flip at a line's end moves a corner by up to two of them
# through the min-area rect and the unclip
TEXT_MATCH_MIN = 0.95
BOX_TOL_PX = 2.0
BOX_MAX_PX = 4.0
# stream against run_many on the same pages: the det chunks have the same
# keys on both paths, so boxes agree to within STREAM_BOX_PX; cross-batch
# accumulation changes the rec batch buckets, and cuBLAS may take another
# kernel for another batch size, so STREAM_TEXT_MIN of the texts must agree
STREAM_BOX_PX = 0.5
STREAM_TEXT_MIN = 0.99
# bench.py config 5: (h, w) of the mixed-size stream, 2 batches of 12
STREAM_SIZES = [(960, 704), (640, 512), (960, 704), (768, 576)]
# server_close() and the session's close() must return within this many s
SERVER_CLOSE_S = 10.0
# train: the port's losses on the fixture batches (testdata/smoke_train.npz)
# and the norm of its parameters' change against the JAX trainer's,
# relative: (loss 1, losses 2-4, change).  Measured on the CPU first
# (tests/test_torch_train_fixture.py, where MEASURED holds the figures),
# then on the card; the bounds are about twice the larger of the two
TRAIN_LOSS_TOL = {"rec": (2e-3, 5e-3, 6e-4), "cls": (5e-4, 2e-3, 1.2e-3),
                  "det": (3e-3, 0.02, 1.5e-3)}
# the tool's batch sizes (tools/train_synthetic.py): rec 128 lines at 48x512,
# cls 128 crops (two views each), det 8 pages at 512x512
TRAIN_BATCH = {"rec": 128, "cls": 128, "det": 8}
TRAIN_TIMED_STEPS = 10
# presets: the server pipeline and the big-vocab rec against their JAX
# fixture (testdata/smoke_presets.npz), by the main path's line rule


def say(phase: str, **kw) -> None:
    print(f"[{phase}] " + " ".join(f"{k}={v}" for k, v in kw.items()), flush=True)


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", flush=True)
    sys.exit(1)


def card() -> tuple[str, str]:
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=30, check=True,
    ).stdout.strip().splitlines()[0]
    say("card", torch=torch.__version__, cuda=torch.version.cuda,
        name=repr(torch.cuda.get_device_name(0)), count=torch.cuda.device_count())
    return smi, torch.cuda.get_device_name(0)


def build() -> None:
    def timed(fn):
        t = time.perf_counter()
        out = fn()
        return out, time.perf_counter() - t

    with ThreadPoolExecutor(max_workers=2) as pool:
        k_fut = pool.submit(timed, kernels.load)
        n_fut = pool.submit(timed, native._load)
        _, k_s = k_fut.result()
        lib, n_s = n_fut.result()
    if lib is None:
        fail("native postprocess (g++) did not build")
    say("build", nvcc_kernels_s=f"{k_s:.2f}", gxx_native_s=f"{n_s:.2f}")
    for line in kernels.build_log().splitlines():  # ptxas -v: registers, spills
        if "registers" in line or "spill" in line or "Compiling entry" in line:
            print(f"[build] {line.strip()}", flush=True)


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


def _epilogue_cases(gen, dev):
    """(name, pred, thresh, dilate, pool, logits): the main path's shape
    first, then the dtypes, pools, modes and halo cases."""
    main = (torch.randn(MAIN_SHAPE, generator=gen, device=dev) * 3).to(torch.bfloat16)
    cases = [("main_bf16_logits_pool2", main, LOGIT_THRESH, True, 2, True)]
    lg = torch.randn((2, 128, 256), generator=gen, device=dev) * 4
    cases.append(("f32_logits_pool2", lg, LOGIT_THRESH, True, 2, True))
    cases.append(("f32_logits_pool4_no_dilate", lg, LOGIT_THRESH, False, 4, True))
    pr = torch.sigmoid(lg)
    cases.append(("f32_probs_pool4", pr, 0.3, True, 4, False))
    cases.append(("bf16_probs_pool2", pr.to(torch.bfloat16), 0.3, True, 2, False))
    cases.append(("bf16_logits_pool4", lg.to(torch.bfloat16), LOGIT_THRESH, True, 4, True))
    # pool 1: the map of a stride-4 det head is already on the det/4 grid
    cases.append(("bf16_logits_pool1", lg.to(torch.bfloat16), LOGIT_THRESH, True, 1, True))
    cases.append(("f32_logits_pool1_no_dilate", lg, LOGIT_THRESH, False, 1, True))
    halo = torch.full((2, 128, 256), -6.0, device=dev)
    halo[0, 63, 100] = 2.0  # last row of a 64-row tile
    halo[1, 7, 0] = 2.0  # row 8r-1 of the next packed row, column 0
    halo[1, 8, 255] = 2.0
    halo[1, 15, 8] = 2.0  # column 8: the left neighbour of a lane's first column
    cases.append(("tile_halo_logits", halo, LOGIT_THRESH, True, 2, True))
    cases.append(("tile_halo_logits_pool1", halo, LOGIT_THRESH, True, 1, True))
    tb = torch.tensor(LOGIT_THRESH).to(torch.bfloat16).to(dev)
    step = torch.randint(-1, 2, (2, 64, 128), generator=gen, device=dev)
    atb = (tb.float() + step * 0.0078125 * tb.abs().float()).to(torch.bfloat16)
    cases.append(("at_threshold_bf16", atb, LOGIT_THRESH, True, 2, True))
    return main, cases


def _mask_cases(gen, dev, main):
    """(name, pred, thresh, dilate) for the two mask-only entry points."""
    cases = [("main_bf16_logit", main, LOGIT_THRESH, True)]
    small = torch.rand((1, 64, 128), generator=gen, device=dev)
    cases.append(("b1_f32_dilate", small, 0.3, True))
    cases.append(("b1_f32_no_dilate", small, 0.3, False))
    halo = torch.zeros((2, 128, 256), device=dev)
    halo[0, 63, 100] = 0.9  # last row of a 64-row tile
    halo[1, 7, 0] = 0.9  # last row of a packed group, column 0
    halo[1, 8, 255] = 0.9
    cases.append(("tile_halo", halo, 0.3, True))
    t32 = torch.tensor(0.3, dtype=torch.float32)
    at = torch.where(torch.rand((1, 128, 128), generator=gen, device=dev) > 0.5,
                     t32.to(dev), torch.zeros((), device=dev))
    cases.append(("at_threshold_f32", at, 0.3, True))
    tb = torch.tensor(LOGIT_THRESH).to(torch.bfloat16)
    atb = torch.where(torch.rand((2, 64, 128), generator=gen, device=dev) > 0.5,
                      tb.to(dev), torch.full((), -5.0, dtype=torch.bfloat16, device=dev))
    cases.append(("at_threshold_bf16", atb, LOGIT_THRESH, True))
    return cases


def kernel_phase() -> dict:
    """The det-epilogue kernel against its plain version on the card,
    bit-exact (mask and prob map), the mask-only entry points likewise,
    then timed at the main path's shape."""
    gen = torch.Generator(device="cuda").manual_seed(0)
    dev = "cuda"
    main, cases = _epilogue_cases(gen, dev)
    max_err = 0
    for name, x, th, dil, pool, lg in cases:
        mask, prob = db_pack.db_epilogue(x, th, dil, pool, lg)
        torch.cuda.synchronize()
        ref_mask, ref_prob = db_pack.db_epilogue_plain(x, th, dil, pool, lg)
        exact = torch.equal(mask, ref_mask) and torch.equal(prob, ref_prob)
        max_err = max(max_err, int((mask.int() - ref_mask.int()).abs().max()),
                      int((prob.int() - ref_prob.int()).abs().max()))
        say("kernel", fn="db_epilogue", case=name, shape=tuple(x.shape),
            dtype=str(x.dtype).split(".")[-1], pool=pool, logits=lg, exact=exact,
            mask_ones=int(mask.ne(0).sum()), prob_sum=int(prob.sum()))
        if not exact:
            fail(f"db_epilogue differs from its plain version on {name}: mask "
                 f"{int(mask.ne(ref_mask).sum())}, prob {int(prob.ne(ref_prob).sum())} bytes")
    for name, x, th, dil in _mask_cases(gen, dev, main):
        got = db_pack.binarize_dilate_pack_rows_batch(x, th, dil)
        torch.cuda.synchronize()
        exact = torch.equal(got, db_pack.binarize_dilate_pack_rows_batch_plain(x, th, dil))
        say("kernel", fn="binarize_dilate_pack_rows_batch", case=name, shape=tuple(x.shape),
            exact=exact, ones=int(got.ne(0).sum()))
        if not exact:
            fail(f"the mask-only kernel differs from its plain version on {name}")
    # the one-map entry point (TPU _kernel) is the B = 1 case
    one = db_pack.binarize_dilate_pack_rows(main[0], LOGIT_THRESH, True)
    if not torch.equal(one, db_pack.binarize_dilate_pack_rows_batch_plain(
            main[:1], LOGIT_THRESH, True)[0]):
        fail("binarize_dilate_pack_rows (B = 1) differs from the plain version")
    say("kernel", fn="binarize_dilate_pack_rows", case="b1_entry_point", exact=True)

    b, h, w = MAIN_SHAPE
    # each input byte read once, each output byte written once
    nbytes = b * h * w * main.element_size() + b * (h // 8) * w + b * (h // 2) * (w // 2)
    bound_ms = nbytes / HBM_BYTES_PER_S * 1e3
    fused = lambda: db_pack.db_epilogue(main, LOGIT_THRESH, True, 2, True)  # noqa: E731
    out = {"ms": device_ms(fused), "host_ms": host_ms(fused), "eager_ms": cuda_ms(fused, 500),
           "plain_ms": cuda_ms(lambda: db_pack.db_epilogue_plain(
               main, LOGIT_THRESH, True, 2, True), 500),
           "bound_ms": bound_ms, "max_abs_err": max_err}
    say("kernel", fn="db_epilogue", timed_shape=MAIN_SHAPE, device_ms=f"{out['ms']:.6f}",
        host_ms=f"{out['host_ms']:.6f}", eager_ms=f"{out['eager_ms']:.6f}",
        plain_ms=f"{out['plain_ms']:.6f}", bound_ms=f"{bound_ms:.6f}", bytes=nbytes)
    # the mask-only mode (TPU _kernel_batched's function) and the one-map
    # entry point (TPU _kernel): not on the main path, timed for the table
    k1 = lambda: db_pack.binarize_dilate_pack_rows_batch(main, LOGIT_THRESH, True)  # noqa: E731
    k1_bytes = b * h * w * main.element_size() + b * (h // 8) * w
    out["mask_only_ms"] = device_ms(k1)
    out["mask_only_host_ms"] = host_ms(k1)
    out["mask_only_plain_ms"] = cuda_ms(lambda: db_pack.binarize_dilate_pack_rows_batch_plain(
        main, LOGIT_THRESH, True), 500)
    out["mask_only_bound_ms"] = k1_bytes / HBM_BYTES_PER_S * 1e3
    say("kernel", fn="binarize_dilate_pack_rows_batch", timed_shape=MAIN_SHAPE,
        device_ms=f"{out['mask_only_ms']:.6f}", host_ms=f"{out['mask_only_host_ms']:.6f}",
        plain_ms=f"{out['mask_only_plain_ms']:.6f}",
        bound_ms=f"{out['mask_only_bound_ms']:.6f}", bytes=k1_bytes)
    # the ONNX path's mode: float32 probabilities at full resolution, pool 4
    ob, oh, ow = ONNX_SHAPE
    probs = torch.sigmoid(torch.randn(ONNX_SHAPE, generator=gen, device=dev) * 3 - 3)
    o_mask, o_prob = db_pack.db_epilogue(probs, 0.3, True, 4, False)
    torch.cuda.synchronize()
    r_mask, r_prob = db_pack.db_epilogue_plain(probs, 0.3, True, 4, False)
    exact = torch.equal(o_mask, r_mask) and torch.equal(o_prob, r_prob)
    say("kernel", fn="db_epilogue", case="onnx_f32_probs_pool4", shape=ONNX_SHAPE,
        dtype="float32", pool=4, logits=False, exact=exact,
        mask_ones=int(o_mask.ne(0).sum()), prob_sum=int(o_prob.sum()))
    if not exact:
        fail("db_epilogue differs from its plain version at the ONNX path's shape")
    o_bytes = ob * oh * ow * probs.element_size() + ob * (oh // 8) * ow + ob * (oh // 4) * (ow // 4)
    onnx = lambda: db_pack.db_epilogue(probs, 0.3, True, 4, False)  # noqa: E731
    out["onnx_ms"] = device_ms(onnx)
    out["onnx_host_ms"] = host_ms(onnx)
    out["onnx_plain_ms"] = cuda_ms(lambda: db_pack.db_epilogue_plain(
        probs, 0.3, True, 4, False), 200)
    out["onnx_bound_ms"] = o_bytes / HBM_BYTES_PER_S * 1e3
    say("kernel", fn="db_epilogue", timed_shape=ONNX_SHAPE, mode="f32_probs_pool4",
        device_ms=f"{out['onnx_ms']:.6f}", host_ms=f"{out['onnx_host_ms']:.6f}",
        plain_ms=f"{out['onnx_plain_ms']:.6f}", bound_ms=f"{out['onnx_bound_ms']:.6f}",
        bytes=o_bytes)
    page = main[0]
    k2 = lambda: db_pack.binarize_dilate_pack_rows(page, LOGIT_THRESH, True)  # noqa: E731
    ms1 = device_ms(k2)
    host1 = host_ms(k2)
    plain1 = cuda_ms(lambda: db_pack.binarize_dilate_pack_rows_batch_plain(
        page[None], LOGIT_THRESH, True), 500)
    bytes1 = k1_bytes // b
    say("kernel", fn="binarize_dilate_pack_rows", timed_shape=tuple(page.shape),
        device_ms=f"{ms1:.6f}", host_ms=f"{host1:.6f}", plain_ms=f"{plain1:.6f}",
        bound_ms=f"{bytes1 / HBM_BYTES_PER_S * 1e3:.6f}", bytes=bytes1)
    return out


def _lines(results, page_ids):
    out = []
    for p, r in zip(page_ids, results):
        if not hasattr(r, "det_result"):
            fail(f"page {p} failed: {r!r}")
        for b, t in zip(r.det_result, r.rec_result):
            box = np.asarray(b.box.pts, np.float32)
            if box.shape != (4, 2) or not np.isfinite(box).all():
                fail(f"page {p}: malformed box {box!r}")
            out.append((p, box, t.text))
    return out


def compare(label: str, got: list, ref_page, ref_boxes, ref_texts):
    """Match each reference line to the port's nearest box on its page.
    Returns (agreeing lines, lines, box distances); prints every line that
    does not agree (text differs, box beyond BOX_TOL_PX, or no partner)."""
    agree, dists = 0, []
    used = set()
    for p, rb, rt in zip(ref_page, ref_boxes, ref_texts):
        cands = [(float(np.abs(b - rb).max()), i) for i, (gp, b, _) in enumerate(got)
                 if gp == p and i not in used]
        if not cands:
            print(f"  {label} page {p}: JAX line {str(rt)!r} has no port line", flush=True)
            continue
        d, i = min(cands)
        used.add(i)
        dists.append(d)
        text = got[i][2]
        if text == rt and d <= BOX_TOL_PX:
            agree += 1
        else:
            print(f"  {label} page {p}: port {text!r} vs JAX {str(rt)!r}, "
                  f"box {d:.2f} px", flush=True)
    extra = len(got) - len(used)
    if extra:
        print(f"  {label}: {extra} port lines without a JAX line", flush=True)
    return agree, len(ref_texts) + extra, dists


def record_graph_calls(dp) -> list:
    """Wrap the pipeline's two graph caches so that every call leaves a
    copy of its arguments and of its outputs, taken on the stream right
    after the call (the outputs are the graph's static tensors)."""
    calls = []
    for name, cache in (("det", dp._det_graphs), ("clsrec", dp._clsrec_graphs)):
        def recording(key, fn, *args, _run=cache.run, _name=name):
            out = _run(key, fn, *args)
            calls.append((_name, key, fn, [a.clone() for a in args],
                          [o.clone() for o in out]))
            return out
        cache.run = recording
    return calls


def stop_recording(dp) -> None:
    for cache in (dp._det_graphs, dp._clsrec_graphs):
        del cache.run


def graphs_against_eager(calls) -> None:
    """Each recorded graph call against its eager function on the same
    inputs, bit for bit."""
    outs = {"det": ("packed_mask", "prob_map", "image_u8"),
            "clsrec": ("cls_probs", "cls_flip", "ctc_idx", "ctc_keep", "rec_scores")}
    n = {"det": 0, "clsrec": 0}
    with torch.inference_mode():
        for name, key, fn, args, got in calls:
            ref = fn(*args)
            torch.cuda.synchronize()
            for label, g, r in zip(outs[name], got, ref):
                if g.shape != r.shape or not torch.equal(g, r):
                    diff = int(g.ne(r).sum()) if g.shape == r.shape else "shape"
                    fail(f"captured {name} {key} differs from eager in {label}: {diff}")
            n[name] += 1
    say("graphs", captured_vs_eager="bit-exact", det_calls=n["det"],
        clsrec_calls=n["clsrec"])
    if not n["det"] or not n["clsrec"]:
        fail("the main path made no det or no cls + rec graph call")


def captures(dp) -> tuple[int, float]:
    """(graphs captured, seconds spent capturing) of a pipeline."""
    caches = (dp._det_graphs, dp._clsrec_graphs)
    return dp.compile_count(), sum(c.capture_s for c in caches)


def fixture_inputs(fx) -> list[np.ndarray]:
    """The 10 fixture inputs: gray pages 0-7 as RGB, page 0 tinted (yuv420
    format), page 2 tinted and rotated (gather warp, cls flip)."""
    pages = [np.repeat(p[..., None], 3, axis=2) for p in fx["pages"]]
    tint = fx["tint"].astype(np.float32)

    def tinted_page(i):
        return np.rint(fx["pages"][i][..., None].astype(np.float32) * tint).astype(np.uint8)

    rotated = ndimage.rotate(tinted_page(2), float(fx["rotate_deg"]), reshape=False,
                             order=1, cval=255)
    return pages + [tinted_page(0), rotated]


def mobile_session(mode: str = "performance", transfer: str = "yuv420") -> RettoSession:
    """A session over the shipped mobile checkpoints on the card."""
    chars = CharacterDict((ROOT / "trained_weights" / "charset.txt").read_text().splitlines())
    weights = {k: str(ROOT / "trained_weights" / f"{k}.npz") for k in ("det", "cls", "rec")}
    cfg = SessionConfig(mode=PipelineMode(mode))
    cfg.engine.transfer_format = transfer
    return RettoSession(cfg, preset="mobile", charset=chars, weights=weights, device="cuda")


def e2e_phase(fx) -> int:
    """Drive the main path, hold it to the fixture, time warm runs; returns
    the db_epilogue launches of the main-path call."""
    t = time.perf_counter()
    session = mobile_session()
    dp = session.device_pipeline()
    say("e2e", session_build_s=f"{time.perf_counter() - t:.2f}")
    inputs = fixture_inputs(fx)
    pages, tinted, rotated = inputs[:8], inputs[8], inputs[9]

    # the main path: counts to 0 just before, read just after
    calls = record_graph_calls(dp)
    db_pack.db_epilogue.launches = 0
    db_pack.binarize_dilate_pack_rows_batch.launches = 0
    t = time.perf_counter()
    res = dp.run_many(pages + [tinted, rotated])
    torch.cuda.synchronize()
    launches = db_pack.db_epilogue.launches
    mask_only = db_pack.binarize_dilate_pack_rows_batch.launches
    stop_recording(dp)
    n_graphs, capture_s = captures(dp)
    say("e2e", main_path_run_many_s=f"{time.perf_counter() - t:.3f}", images=len(res),
        db_epilogue_launches=launches, mask_only_launches=mask_only,
        formats="gray+yuv420", compile_count=n_graphs, capture_s=f"{capture_s:.2f}")
    if launches <= 0:
        fail("the main path never launched the db_epilogue kernel")
    if mask_only:
        fail("the main path launched the mask-only kernel beside db_epilogue")
    graphs_against_eager(calls)
    del calls
    gray = _lines(res[:8], range(len(pages)))
    eq_g, n_g, d_g = compare("gray", gray, fx["jax_page"], fx["jax_boxes"], fx["jax_texts"])
    eq_t, n_t, d_t = compare("tinted", _lines(res[8:9], [0]), fx["jax_tinted_page"],
                             fx["jax_tinted_boxes"], fx["jax_tinted_texts"])
    eq_o, n_o, d_o = compare("rotated", _lines(res[9:], [2]), fx["jax_rotated_page"],
                             fx["jax_rotated_boxes"], fx["jax_rotated_texts"])
    rot = res[9]
    flips = sum(c.label == 180 for c in rot.cls_result)
    gathered = sum(not _is_aligned(b.box.pts) for b in rot.det_result)
    say("e2e", rotated_lines=len(rot.det_result), cls_flips=flips,
        gather_warp_lines=gathered)
    if not flips or not gathered:
        fail("the rotated page took no cls flip or no gather warp")

    dp_rgb = mobile_session(transfer="rgb").device_pipeline()
    before = db_pack.db_epilogue.launches
    res_rgb = dp_rgb.run_many([pages[1]])
    rgb_launches = db_pack.db_epilogue.launches - before
    eq_r, n_r, d_r = compare("rgb", _lines(res_rgb, [1]), fx["jax_rgb_page"],
                             fx["jax_rgb_boxes"], fx["jax_rgb_texts"])
    agree, total = eq_g + eq_t + eq_o + eq_r, n_g + n_t + n_o + n_r
    dists = d_g + d_t + d_o + d_r
    frac = agree / max(total, 1)
    texts_equal = sum(
        t == str(rt) for t, rt in zip([x[2] for x in gray], fx["jax_texts"])
    )
    say("e2e", lines_agreeing_with_jax=f"{agree}/{total}", fraction=f"{frac:.4f}",
        gray=f"{eq_g}/{n_g}", tinted=f"{eq_t}/{n_t}", rotated=f"{eq_o}/{n_o}",
        rgb=f"{eq_r}/{n_r}",
        gray_texts_equal_in_order=f"{texts_equal}/{len(fx['jax_texts'])}",
        box_max_px=f"{max(dists, default=0.0):.2f}",
        boxes_beyond_tol=sum(d > BOX_TOL_PX for d in dists),
        rgb_db_epilogue_launches=rgb_launches)
    if total == 0 or frac < TEXT_MATCH_MIN:
        fail(f"only {agree}/{total} lines agree with the JAX pipeline")
    if max(dists, default=0.0) > BOX_MAX_PX:
        fail(f"a box lies {max(dists):.2f} px from the JAX pipeline's (> {BOX_MAX_PX})")
    gt = set(str(t) for t in fx["gt_texts"])
    say("e2e", port_lines_equal_to_ground_truth=f"{sum(t in gt for _, _, t in gray)}/"
        f"{len(fx['gt_texts'])}")

    # warm 16-page runs (bench.py config 3's batch)
    batch = pages + pages
    dp.run_many(batch)
    torch.cuda.synchronize()
    times = []
    launches16 = 0
    compiles0 = dp.compile_count()
    for _ in range(5):
        db_pack.db_epilogue.launches = 0
        t = time.perf_counter()
        dp.run_many(batch)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t)
        launches16 = db_pack.db_epilogue.launches
    med = sorted(times)[len(times) // 2]
    stats = {k: (round(v, 6) if isinstance(v, float) else v)
             for k, v in dp.last_stats.items()}
    say("e2e", pages=len(batch), images_per_s_median=f"{len(batch) / med:.3f}",
        images_per_s_best=f"{len(batch) / min(times):.3f}",
        images_per_s_worst=f"{len(batch) / max(times):.3f}",
        run_s=[round(x, 4) for x in times], db_epilogue_launches_per_run=launches16,
        compile_count=dp.compile_count(), captures_in_timed_region=dp.compile_count() - compiles0)
    print("[e2e] last_stats " + json.dumps(stats), flush=True)
    if dp.compile_count() != compiles0:
        fail("the timed 16-page runs captured a new graph")
    dp.close()
    dp_rgb.close()
    return launches


def _resized(page: np.ndarray, h: int, w: int) -> np.ndarray:
    t = torch.from_numpy(page).float()[None, None]
    out = torch.nn.functional.interpolate(t, size=(h, w), mode="bilinear",
                                          antialias=True, align_corners=False)
    gray = out[0, 0].round().clamp(0, 255).to(torch.uint8).numpy()
    return np.repeat(gray[..., None], 3, axis=2)


def stream_phase(fx) -> None:
    """bench.py config 5's protocol on the port: mixed-size pages in 2
    batches of 12, streamed 3 times, at the mobile checkpoints' full
    widths; ``stream`` against ``run_many`` per batch."""
    with mobile_session() as session:
        dp = session.device_pipeline()
        src = fx["pages"]
        pages = [_resized(src[(k * len(STREAM_SIZES) + i) % len(src)], h, w)
                 for k in range(6) for i, (h, w) in enumerate(STREAM_SIZES)]
        batches = [pages[:12], pages[12:]]
        stream_in = [b for _ in range(3) for b in batches]
        t = time.perf_counter()
        seq = [dp.run_many(b) for b in batches]
        for _ in dp.stream(stream_in):
            pass  # the warm pass captures every key the timed pass meets
        torch.cuda.synchronize()
        n_graphs, capture_s = captures(dp)
        say("stream", pages=len(pages), sizes=STREAM_SIZES, warm_s=f"{time.perf_counter() - t:.2f}",
            compile_count=n_graphs, capture_s=f"{capture_s:.2f}")
        dp.metrics = type(dp.metrics)()
        pads0 = dp.pad_concats
        compiles0 = dp.compile_count()
        db_pack.db_epilogue.launches = 0
        t = time.perf_counter()
        got = list(dp.stream(stream_in))
        torch.cuda.synchronize()
        dt = time.perf_counter() - t
        launches = db_pack.db_epilogue.launches
        occ = dp.metrics.summary()["bucket_occupancy"]
        new_captures = dp.compile_count() - compiles0
        say("stream", images=sum(len(b) for b in got), images_per_s=f"{sum(len(b) for b in got) / dt:.3f}",
            rec_batch_occupancy=occ.get("rec_batch"), det_batch_occupancy=occ.get("det_batch"),
            pad_concats=dp.pad_concats - pads0, db_epilogue_launches=launches,
            compile_count=dp.compile_count(), captures_in_timed_region=new_captures)
        print("[stream] bucket_occupancy " + json.dumps(occ), flush=True)
        if new_captures:
            fail("the timed stream pass captured a new graph")
        if dp.pad_concats == pads0:
            fail("the mixed-size stream never took the cross-shape pad + concat")
        if launches <= 0:
            fail("the stream never launched the db_epilogue kernel")
        lines = equal = 0
        box_max = 0.0
        for k, out in enumerate(got):
            ref = seq[k % 2]
            for i, (r, g) in enumerate(zip(ref, out)):
                if len(g.det_result) != len(r.det_result):
                    fail(f"stream batch {k} page {i}: {len(g.det_result)} boxes, "
                         f"run_many {len(r.det_result)}")
                for rb, gb, rt, gt in zip(r.det_result, g.det_result, r.rec_result,
                                          g.rec_result):
                    d = float(np.abs(np.asarray(gb.box.pts) - np.asarray(rb.box.pts)).max())
                    box_max = max(box_max, d)
                    lines += 1
                    if gt.text == rt.text:
                        equal += 1
                    else:
                        print(f"  stream batch {k} page {i}: stream {gt.text!r} vs "
                              f"run_many {rt.text!r}, box {d:.2f} px", flush=True)
        say("stream", lines=lines, texts_equal_to_run_many=f"{equal}/{lines}",
            box_max_px=f"{box_max:.2f}")
        if box_max > STREAM_BOX_PX:
            fail(f"a stream box lies {box_max:.2f} px from run_many's (> {STREAM_BOX_PX})")
        if not lines or equal / lines < STREAM_TEXT_MIN:
            fail(f"only {equal}/{lines} stream texts equal run_many's")


def texts_of(results) -> list[list[str]]:
    return [[t.text for t in r.rec_result] for r in results]


def staged_phase(fx, sessions: dict) -> dict:
    """The staged ``RettoSession.run`` (``TorchEngine`` + the three stages)
    in COMPAT and PERFORMANCE mode on the 10 fixture inputs, held to the JAX
    staged session's lines (``smoke_staged.npz``) by ``compare``'s rule;
    ``run_stream`` and ``run_many``; warm images/s and the per-stage split;
    then the staged path and the fused pipeline from two threads at once.
    Returns the single-thread texts per mode and of the fused pipeline."""
    ref = np.load(ROOT / "retto_tpu_torch" / "testdata" / "smoke_staged.npz")
    inputs = fixture_inputs(fx)
    out: dict = {}
    for mode in ("compat", "performance"):
        session = sessions[mode]
        db_pack.db_epilogue.launches = 0
        t = time.perf_counter()
        res = [session.run(x) for x in inputs]
        torch.cuda.synchronize()
        first_s = time.perf_counter() - t
        shapes_first = session.engine.compiled_shapes()
        agree, total, dists = compare(f"staged-{mode}", _lines(res, range(len(inputs))),
                                      ref[f"{mode}_page"], ref[f"{mode}_boxes"],
                                      ref[f"{mode}_texts"])
        frac = agree / max(total, 1)
        say("staged", mode=mode, lines_agreeing_with_jax_staged=f"{agree}/{total}",
            fraction=f"{frac:.4f}", box_max_px=f"{max(dists, default=0.0):.2f}",
            first_pass_s=f"{first_s:.3f}", compiled_shapes=json.dumps(shapes_first),
            db_epilogue_launches=db_pack.db_epilogue.launches)
        if total == 0 or frac < TEXT_MATCH_MIN:
            fail(f"staged {mode}: only {agree}/{total} lines agree with the JAX session")
        if max(dists, default=0.0) > BOX_MAX_PX:
            fail(f"staged {mode}: a box lies {max(dists):.2f} px from the JAX session's")
        events = []
        session.run_stream(inputs[9], events.append)
        if [e.stage for e in events] != ["det", "cls", "rec"]:
            fail(f"staged {mode}: run_stream gave {[e.stage for e in events]}")
        if [e.result.to_dict() for e in events] != [
                res[9].det_result.to_dict(), res[9].cls_result.to_dict(),
                res[9].rec_result.to_dict()]:
            fail(f"staged {mode}: run_stream's events differ from run")
        many = session.run_many([inputs[1], b"not an image", inputs[1]])
        if not isinstance(many[1], RettoError) or texts_of([many[0], many[2]]) != \
                texts_of([res[1], res[1]]):
            fail(f"staged {mode}: run_many did not isolate the corrupt input")
        times = []
        stage0 = dict(session.metrics.stage_time)
        for _ in range(3):
            t = time.perf_counter()
            for x in inputs:
                session.run(x)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t)
        per_img = {k: round((v - stage0.get(k, 0.0)) / (3 * len(inputs)) * 1e3, 3)
                   for k, v in session.metrics.stage_time.items()}
        med = sorted(times)[1]
        out[mode] = {"images_per_s": len(inputs) / med, "texts": texts_of(res)}
        say("staged", mode=mode, images=len(inputs),
            images_per_s_median=f"{len(inputs) / med:.3f}",
            pass_s=[round(x, 4) for x in times],
            first_pass_extra_s=f"{first_s - med:.3f}",
            stage_ms_per_image=json.dumps(per_img),
            compiled_shapes=json.dumps(session.engine.compiled_shapes()))
        if session.engine.compiled_shapes() != shapes_first:
            fail(f"staged {mode}: the warm passes met a new input shape")

    # the session's one dispatch lock: staged and fused from two threads
    session = sessions["performance"]
    dp = session.device_pipeline()
    out["fused"] = texts_of(dp.run_many(inputs))
    got: dict = {}

    def staged():
        got["staged"] = texts_of([session.run(x) for x in inputs])

    def fused():
        got["fused"] = texts_of(dp.run_many(inputs))

    db_pack.db_epilogue.launches = 0
    with ThreadPoolExecutor(max_workers=2) as pool:
        futs = [pool.submit(staged), pool.submit(fused)]
        for f in futs:
            f.result(timeout=300)
    torch.cuda.synchronize()
    same = got["staged"] == out["performance"]["texts"] and got["fused"] == out["fused"]
    say("staged", two_threads="staged+fused", texts_equal_single_thread=same,
        db_epilogue_launches=db_pack.db_epilogue.launches)
    if not same:
        fail("the staged and fused paths driven together gave other texts than alone")
    return out


def write_png(path: Path, img: np.ndarray) -> None:
    """A minimal PNG (8-bit gray or RGB, no filter) from the standard library."""
    import struct
    import zlib

    gray = img.ndim == 2 or bool((img == img[..., :1]).all())
    px = img if img.ndim == 2 else (img[..., 0] if gray else img)
    h, w = px.shape[:2]
    raw = b"".join(b"\x00" + px[y].tobytes() for y in range(h))

    def chunk(tag: bytes, data: bytes) -> bytes:
        body = tag + data
        return struct.pack(">I", len(data)) + body + struct.pack(">I", zlib.crc32(body))

    ihdr = struct.pack(">IIBBBBB", w, h, 8, 0 if gray else 2, 0, 0, 0)
    path.write_bytes(b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", ihdr)
                     + chunk(b"IDAT", zlib.compress(raw, 6)) + chunk(b"IEND", b""))


def cli_phase(fx, staged: dict, kind: str, workdir: Path) -> None:
    """``python3 -m retto_tpu_torch.cli`` in subprocesses: ``ocr`` on the
    fixture inputs written as PNGs, staged and with ``--device-pipeline``,
    must read the session's texts; ``info`` must name the card."""
    pngs = workdir / "pages"
    pngs.mkdir(parents=True, exist_ok=True)
    for i, x in enumerate(fixture_inputs(fx)):
        write_png(pngs / f"p{i:02d}.png", x)
    for label, extra, want in (("staged", [], staged["performance"]["texts"]),
                               ("fused", ["--device-pipeline"], staged["fused"])):
        out = workdir / f"{label}.jsonl"
        t = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-m", "retto_tpu_torch.cli", "ocr", str(pngs), "--weights-dir",
             str(ROOT / "trained_weights"), "--json-out", str(out), *extra],
            capture_output=True, text=True, timeout=300, cwd=ROOT)
        if proc.returncode != 0:
            print(proc.stderr[-3000:], flush=True)
            fail(f"the CLI ({label}) exited {proc.returncode}")
        lines = [json.loads(x) for x in out.read_text().splitlines()]
        texts = [[t["text"] for t in x["texts"]] for x in lines]
        say("cli", path=label, files=len(lines), s=f"{time.perf_counter() - t:.2f}",
            texts_equal_session=texts == want, summary=repr(proc.stderr.strip().splitlines()[-1]))
        if texts != want:
            fail(f"the CLI ({label}) read other texts than the session")
    proc = subprocess.run([sys.executable, "-m", "retto_tpu_torch.cli", "info"],
                          capture_output=True, text=True, timeout=300, cwd=ROOT)
    print(proc.stdout.strip(), flush=True)
    if proc.returncode != 0 or kind not in proc.stdout:
        fail(f"retto-torch info exited {proc.returncode} without naming the card")


def _post(url: str, data: bytes, timeout: float = 120.0) -> bytes:
    import urllib.request

    req = urllib.request.Request(url, data=data, method="POST")
    with urllib.request.urlopen(req, timeout=timeout) as r:
        return r.read()


def serve_phase(fx, sessions: dict, staged: dict, workdir: Path) -> int:
    """``serve.make_server`` on port 0: a PERFORMANCE session serves 8
    concurrent ``/ocr`` POSTs through ``DevicePipeline.run_many`` on the
    batcher thread (the db_epilogue kernel runs there), ``/ocr/stream``,
    ``/metrics`` and ``/healthz``; then a COMPAT session serves ``/ocr``
    through the staged path.  Returns the kernel launches of the timed
    ``/ocr`` round."""
    import threading
    import urllib.request

    pages = [(workdir / "pages" / f"p{i:02d}.png").read_bytes() for i in range(8)]
    session = sessions["performance"]
    ref = texts_of(session.device_pipeline().run_many(pages))
    srv = make_server(session, "127.0.0.1", 0, max_wait_ms=20.0)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    url = f"http://127.0.0.1:{srv.server_address[1]}"

    def one(data: bytes) -> tuple[list[str], float]:
        t = time.perf_counter()
        body = json.loads(_post(f"{url}/ocr", data))
        return [r["text"] for r in body["rec_result"]], time.perf_counter() - t

    dp = session.device_pipeline()
    with ThreadPoolExecutor(max_workers=8) as pool:
        list(pool.map(one, pages))  # warm: captures the batch shapes' graphs
        db_pack.db_epilogue.launches = 0
        b0, c0 = srv.batcher.batches, dp.compile_count()
        got = list(pool.map(one, pages))
    launches = db_pack.db_epilogue.launches
    lat = sorted(ms for _, ms in got)
    texts = [t for t, _ in got]
    say("serve", mode="performance", requests=len(pages), concurrency=8,
        batches=srv.batcher.batches - b0, captures_in_timed_round=dp.compile_count() - c0,
        texts_equal_run_many=texts == ref,
        ocr_latency_ms_p50=f"{(lat[3] + lat[4]) / 2 * 1e3:.3f}",
        ocr_latency_ms_max=f"{lat[-1] * 1e3:.3f}", db_epilogue_launches=launches)
    if texts != ref:
        fail("the server's /ocr texts differ from run_many's")
    if launches <= 0:
        fail("the server's /ocr never launched the db_epilogue kernel")
    lines = [json.loads(x) for x in _post(f"{url}/ocr/stream", pages[3]).splitlines() if x]
    with urllib.request.urlopen(f"{url}/metrics", timeout=30) as r:
        metrics = json.loads(r.read())
    with urllib.request.urlopen(f"{url}/healthz", timeout=30) as r:
        health = json.loads(r.read())
    say("serve", stream_stages=[x.get("stage") for x in lines],
        avg_batch=metrics["avg_batch"], healthz=health)
    if [x.get("stage") for x in lines] != ["det", "cls", "rec"]:
        fail("/ocr/stream did not give det, cls, rec")
    if lines[2]["result"] and [r["text"] for r in lines[2]["result"]] != ref[3]:
        fail("/ocr/stream's rec texts differ from run_many's")
    if not metrics["avg_batch"] > 1 or health != {"ok": True}:
        fail(f"/metrics avg_batch {metrics['avg_batch']} or /healthz {health}")
    t = time.perf_counter()
    srv.shutdown()
    srv.server_close()
    session.close()
    close_s = time.perf_counter() - t

    compat = sessions["compat"]
    srv = make_server(compat, "127.0.0.1", 0)
    if srv.batcher.runner is not compat:
        fail("a COMPAT session's /ocr does not run the staged session")
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    url = f"http://127.0.0.1:{srv.server_address[1]}"
    body = json.loads(_post(f"{url}/ocr", pages[1]))
    compat_ok = [r["text"] for r in body["rec_result"]] == staged["compat"]["texts"][1]
    t = time.perf_counter()
    srv.shutdown()
    srv.server_close()
    compat.close()
    close_s = max(close_s, time.perf_counter() - t)
    say("serve", mode="compat", ocr_texts_equal_staged_run=compat_ok,
        close_s_max=f"{close_s:.3f}")
    if not compat_ok:
        fail("the COMPAT server's /ocr texts differ from the staged session's")
    if close_s > SERVER_CLOSE_S:
        fail(f"server_close() and close() took {close_s:.1f} s (> {SERVER_CLOSE_S})")
    return launches


def train_model(kind: str, device: str):
    """The shipped mobile checkpoint of ``kind`` in a port model with float32
    parameters computing in bf16, on ``device``."""
    wd = ROOT / "trained_weights"
    flat, meta = load_params_meta(wd / f"{kind}.npz")
    kw = {k: tuple(v) if isinstance(v, list) else v for k, v in meta["overrides"].items()}
    build = {"det": build_det, "cls": build_cls, "rec": build_rec}[kind]
    if kind == "rec":
        kw["num_classes"] = len((wd / "charset.txt").read_text().splitlines()) + 2
    return load_flax_params(build(meta["preset"], compute_dtype="bfloat16", **kw), flat).to(device)


def train_data(kind: str, fx, device: str):
    """The fixture's ``kind`` dataset on ``device``, in the train.data holder."""
    t = {k: torch.from_numpy(fx[k]).to(device) for k in fx.files if k.startswith(kind)}
    if kind == "rec":
        return RecDeviceData(t["rec_lines"], t["rec_widths"], t["rec_labels"], t["rec_lengths"])
    if kind == "cls":
        return ClsDeviceData(t["cls_lines"], t["cls_widths"])
    return DetDeviceData(t["det_pages"], t["det_boxes"])


def train_batch(kind: str, fx, device: str, model):
    """(batch tensors, loss_fn, forward) of the fixture's ``kind`` batch,
    gathered without augmentation."""
    data = train_data(kind, fx, device)
    if kind == "rec":
        x, lab, ln = gather_rec_batch(data, torch.arange(len(data.lines), device=device))
        return (x, lab, ln), ctc_loss, lambda m, v: m(v, return_logits=True)
    if kind == "cls":
        idx = torch.arange(len(data.lines), device=device)
        rot = torch.from_numpy(fx["cls_rot"]).to(device).long()
        x, lab = gather_cls_batch(data, idx, rot)
        x_opp, _ = gather_cls_batch(data, idx, 1 - rot)
        return (torch.cat([x, x_opp]), lab), _cls_loss_sym, None
    idx = torch.arange(len(data.pages), device=device)
    return gather_det_batch(data, idx, out_stride=model.out_stride), db_loss, None


def train_fixture_losses(fx, kind: str, device: str):
    """Four steps from the shipped checkpoint on the fixture batch under
    the tool's AdamW schedule for three (the first and the fourth update
    at rate 0): (losses, the L2 norm of the parameters' change, model,
    state, batch).  Fails on a non-finite loss or gradient."""
    model = train_model(kind, device)
    batch, loss_fn, forward = train_batch(kind, fx, device, model)
    state = init_train_state(model, warmup_cosine_decay(float(fx[f"{kind}_lr"]), 1, 3))
    step = make_train_step(model, loss_fn, forward=forward)
    start = [p.detach().clone() for p in model.parameters()]
    losses = []
    for i in range(4):
        state, loss = step(state, *batch)
        losses.append(float(loss))
        bad = [n for n, p in model.named_parameters()
               if p.grad is None or not torch.isfinite(p.grad).all()]
        if not math.isfinite(losses[-1]) or bad:
            fail(f"train {kind} step {i + 1}: loss {losses[-1]}, non-finite gradients {bad[:3]}")
    with torch.no_grad():
        delta = math.sqrt(sum(float(torch.sum((p - p0) ** 2))
                              for p, p0 in zip(model.parameters(), start)))
    return losses, delta, model, state, batch


def train_phase() -> dict:
    """The training path on the card: each target from its shipped
    checkpoint on the fixture batch against the JAX trainer's losses; a
    checkpoint save/restore and a Flax-layout export that reloads; then
    warm steps at the tool's batch sizes."""
    fx = np.load(ROOT / "retto_tpu_torch" / "testdata" / "smoke_train.npz")
    out = {}
    for kind in ("rec", "cls", "det"):
        losses, delta, model, state, batch = train_fixture_losses(fx, kind, "cuda")
        ref = fx[f"{kind}_losses"].astype(float)
        ref_delta = float(fx[f"{kind}_delta_norm"])
        rel = [abs(a - b) / abs(b) for a, b in zip(losses, ref)]
        rel_delta = abs(delta - ref_delta) / ref_delta
        tol1, tol, tol_delta = TRAIN_LOSS_TOL[kind]
        say("train", kind=kind, losses=[round(v, 6) for v in losses],
            jax_losses=[round(float(v), 6) for v in ref], rel_diff=[f"{r:.2e}" for r in rel],
            delta_norm=round(delta, 6), jax_delta_norm=round(ref_delta, 6),
            delta_rel_diff=f"{rel_delta:.2e}", tol=(tol1, tol, tol_delta))
        if rel[0] > tol1 or max(rel[1:]) > tol or rel_delta > tol_delta:
            fail(f"train {kind}: losses {losses} and change {delta} against JAX "
                 f"{ref.tolist()} and {ref_delta}")
        if kind == "cls":
            checkpoint_check(model, state, batch)
        out[kind] = train_speed(kind, fx)
        del model, state, batch
        torch.cuda.empty_cache()
    return out


def checkpoint_check(model, state, batch) -> None:
    """CheckpointManager save and restore into a fresh state, and
    ``save_params`` of the trained model reloaded into a fresh port model:
    equal parameters and equal inference outputs."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        mgr = CheckpointManager(tmp, keep=2)
        mgr.save(state.step, state)
        fresh = init_train_state(train_model("cls", "cuda"), 1e-3)
        restored = mgr.restore(fresh)
        mgr.close()
        same = all(torch.equal(a, b) for a, b in zip(model.state_dict().values(),
                                                    restored.model.state_dict().values()))
        path = Path(tmp) / "cls.npz"
        save_params(path, export_flax_params(model), meta={"preset": "mobile", "overrides": {}})
        flat, _ = load_params_meta(path)
        reloaded = load_flax_params(build_cls("mobile", compute_dtype="bfloat16"), flat)
        model.eval()
        reloaded.to("cuda").eval()
        with torch.no_grad():
            equal = torch.equal(model(batch[0]), reloaded(batch[0]))
        model.train()
    say("train", checkpoint_restored_equal=same, restored_step=restored.step,
        exported_npz_outputs_equal=equal)
    if not same or restored.step != state.step or not equal:
        fail("a checkpoint did not restore, or the exported npz did not reload equal")


def train_speed(kind: str, fx) -> dict:
    """Warm train steps at the tool's batch size, each the step of the
    tool's loop (retto_tpu_torch/train/synthetic.py): indices drawn on the
    host and uploaded, the batch gathered and augmented on the device with
    a torch.Generator (for det with its GT maps from ``db_gt_device``), the
    train step, and for rec the EMA of the weights.  steps/s of the median
    step (each synchronized), with the spread."""
    torch.cuda.reset_peak_memory_stats()
    model = train_model(kind, "cuda")
    data = train_data(kind, fx, "cuda")
    n, b = len(data.pages if kind == "det" else data.lines), TRAIN_BATCH[kind]
    _, loss_fn, forward = train_batch(kind, fx, "cuda", model)
    state = init_train_state(model, 1e-4)
    step = make_train_step(model, loss_fn, forward=forward)
    rng = np.random.default_rng(0)
    gen = torch.Generator(device="cuda").manual_seed(0)
    params = list(model.parameters())
    ema = [p.detach().clone() for p in params]

    def tool_step():
        idx = torch.from_numpy(rng.integers(0, n, b)).to("cuda")
        if kind == "rec":
            x, lab, ln = gather_rec_batch(data, idx, generator=gen)
            st, loss = step(state, x, lab, ln)
            with torch.no_grad():
                torch._foreach_mul_(ema, 0.999)
                torch._foreach_add_(ema, [p.detach() for p in params], alpha=0.001)
            return st, loss
        if kind == "cls":
            return step(state, *_cls_views(data, idx, rng, gen))
        return step(state, *gather_det_batch(data, idx, out_stride=model.out_stride,
                                              generator=gen))

    for _ in range(3):
        state, loss = tool_step()
    torch.cuda.synchronize()
    times = []
    for _ in range(TRAIN_TIMED_STEPS):
        t = time.perf_counter()
        state, loss = tool_step()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t)
    if not math.isfinite(float(loss)):
        fail(f"train {kind}: non-finite loss at batch {TRAIN_BATCH[kind]}")
    times.sort()
    med = times[len(times) // 2]
    res = {"batch": TRAIN_BATCH[kind], "steps_per_s_median": 1 / med,
           "steps_per_s_best": 1 / times[0], "steps_per_s_worst": 1 / times[-1],
           "peak_mem_gib": torch.cuda.max_memory_allocated() / 2 ** 30}
    say("train", kind=kind, batch=TRAIN_BATCH[kind],
        steps_per_s_median=f"{res['steps_per_s_median']:.3f}",
        steps_per_s_best=f"{res['steps_per_s_best']:.3f}",
        steps_per_s_worst=f"{res['steps_per_s_worst']:.3f}",
        step_ms=[round(x * 1e3, 2) for x in times],
        peak_mem_gib=f"{res['peak_mem_gib']:.2f}")
    return res


def presets_phase() -> None:
    """The server preset through the fused pipeline on the 8 gray fixture
    pages, and the big-vocab rec alone on 16 crops at 48x320, each against
    its JAX fixture by the main path's line rule."""
    fx = np.load(ROOT / "retto_tpu_torch" / "testdata" / "smoke_presets.npz")
    pages = np.load(ROOT / "retto_tpu_torch" / "testdata" / "smoke_pages.npz")["pages"]
    wd = ROOT / "trained_weights"
    chars = CharacterDict((wd / "charset.txt").read_text().splitlines())
    weights = {"det": str(wd / "det_server.npz"), "cls": str(wd / "cls.npz"),
               "rec": str(wd / "rec_server.npz")}
    cfg = SessionConfig()
    cfg.engine.transfer_format = "yuv420"
    with RettoSession(cfg, preset="server", charset=chars, weights=weights,
                      device="cuda") as session:
        dp = session.device_pipeline()
        rgb = [np.repeat(p[..., None], 3, axis=2) for p in pages]
        dp.run_many(rgb)
        torch.cuda.synchronize()
        t = time.perf_counter()
        res = dp.run_many(rgb)
        torch.cuda.synchronize()
        run_s = time.perf_counter() - t
        dp.close()
    agree, total, dists = compare("server", _lines(res, range(len(pages))), fx["server_page"],
                                  fx["server_boxes"], fx["server_texts"])
    frac = agree / max(total, 1)
    say("presets", preset="server", lines_agreeing_with_jax=f"{agree}/{total}",
        fraction=f"{frac:.4f}", box_max_px=f"{max(dists, default=0.0):.2f}",
        warm_run_many_s=f"{run_s:.3f}", images_per_s=f"{len(pages) / run_s:.3f}")
    if total == 0 or frac < TEXT_MATCH_MIN or max(dists, default=0.0) > BOX_MAX_PX:
        fail(f"server preset: {agree}/{total} lines agree, box "
             f"{max(dists, default=0.0):.2f} px")

    big = CharacterDict((wd / "charset_big.txt").read_text(encoding="utf-8").splitlines())
    flat, meta = load_params_meta(wd / "rec_big.npz")
    model = load_flax_params(build_rec(meta["preset"], num_classes=big.num_classes,
                                       compute_dtype="bfloat16", **meta["overrides"]), flat)
    model = cast_compute(model, torch.bfloat16).to("cuda").eval()
    crops = torch.from_numpy(fx["big_crops"]).cuda()
    x = (crops.float() / 255.0 - 0.5) / 0.5
    col = torch.arange(x.shape[2], device="cuda")[None, None, :, None]
    x = torch.where(col < torch.from_numpy(fx["big_widths"]).cuda()[:, None, None, None], x, 0.0)
    with torch.inference_mode():
        idx, keep, _ = ctc_greedy_decode(model(x.permute(0, 3, 1, 2).contiguous()))
    texts = big.decode_indices(idx.cpu().numpy(), keep.cpu().numpy())
    agree = sum(a == str(b) for a, b in zip(texts, fx["big_texts"]))
    right = sum(a == str(b) for a, b in zip(texts, fx["big_gt"]))
    say("presets", preset="rec_big", classes=big.num_classes,
        lines_agreeing_with_jax=f"{agree}/{len(texts)}", lines_read_right=f"{right}/{len(texts)}")
    if agree / len(texts) < TEXT_MATCH_MIN:
        fail(f"big-vocab rec: {agree}/{len(texts)} lines agree with JAX")


def onnx_session(mode: str = "performance") -> RettoSession:
    """A session over the three full-size Paddle-export replicas
    (``weights/replica.py``) through ``OnnxEngine`` on the card, with the
    det settings of the JAX fixture (tools/make_torch_smoke_fixture.py
    ``onnx_det_config``: box_thresh 0.2, dilation)."""
    chars = CharacterDict((ROOT / "trained_weights" / "charset_big.txt")
                          .read_text(encoding="utf-8").splitlines())
    engine = OnnxEngine(det=build_det_replica(), cls=build_cls_replica(),
                        rec=build_rec_replica(), device="cuda")
    cfg = SessionConfig(mode=PipelineMode(mode))
    cfg.engine.transfer_format = "yuv420"
    cfg.det.box_thresh = 0.2
    cfg.det.use_dilation = True
    return RettoSession(cfg, engine=engine, charset=chars, device="cuda")


def _per_page(label: str, lines: list, n_pages: int) -> None:
    counts = np.bincount([p for p, _, _ in lines], minlength=n_pages)
    if (counts[:n_pages] == 0).any():
        fail(f"{label}: no box on pages {np.flatnonzero(counts[:n_pages] == 0).tolist()}")


def onnx_phase(fx) -> int:
    """The ONNX path: the replica OnnxEngine's fused ``run_many`` over the
    8 gray pages and the rotated page (the det epilogue in its float32
    probability, pool-4 mode), its graphs against eager, the staged COMPAT
    session over the 10 fixture inputs, both held to the JAX fixture
    (``testdata/smoke_onnx.npz``) by phase 3's line rule, then warm 16-page
    calls timed; returns the db_epilogue launches of the fused call."""
    fxo = np.load(ROOT / "retto_tpu_torch" / "testdata" / "smoke_onnx.npz")
    t = time.perf_counter()
    session = onnx_session()
    dp = session.device_pipeline()
    say("onnx", session_build_s=f"{time.perf_counter() - t:.2f}")
    inputs = fixture_inputs(fx)
    fused_in = inputs[:8] + [inputs[9]]

    modes = []
    orig = device_pipeline.db_epilogue

    def recording(pred, thresh, dilate, pool, logits):
        modes.append((str(pred.dtype).split(".")[-1], tuple(pred.shape), pool, logits))
        return orig(pred, thresh, dilate, pool, logits)

    device_pipeline.db_epilogue = recording
    calls = record_graph_calls(dp)
    db_pack.db_epilogue.launches = 0
    t = time.perf_counter()
    try:
        res = dp.run_many(fused_in)
        torch.cuda.synchronize()
    finally:
        device_pipeline.db_epilogue = orig
    launches = db_pack.db_epilogue.launches
    stop_recording(dp)
    n_graphs, capture_s = captures(dp)
    say("onnx", fused_run_many_s=f"{time.perf_counter() - t:.3f}", images=len(res),
        db_epilogue_launches=launches, epilogue_modes=sorted(set(modes)),
        compile_count=n_graphs, capture_s=f"{capture_s:.2f}")
    if launches <= 0:
        fail("the ONNX path never launched the db_epilogue kernel")
    if not modes or any(m[0] != "float32" or m[2] != 4 or m[3] for m in modes):
        fail(f"the ONNX path's det epilogue ran in another mode: {sorted(set(modes))}")
    graphs_against_eager(calls)
    del calls
    got = _lines(res, list(range(8)) + [8])
    _per_page("onnx fused", got, 9)
    agree, total, dists = compare("onnx fused", got, fxo["fused_page"], fxo["fused_boxes"],
                                  fxo["fused_texts"])
    frac = agree / max(total, 1)
    say("onnx", fused_lines_agreeing_with_jax=f"{agree}/{total}", fraction=f"{frac:.4f}",
        box_max_px=f"{max(dists, default=0.0):.2f}",
        boxes_beyond_tol=sum(d > BOX_TOL_PX for d in dists))
    if total == 0 or frac < TEXT_MATCH_MIN or max(dists, default=0.0) > BOX_MAX_PX:
        fail(f"ONNX fused: {agree}/{total} lines agree, box {max(dists, default=0.0):.2f} px")

    batch = inputs[:8] + inputs[:8]
    dp.run_many(batch)
    torch.cuda.synchronize()
    times = []
    compiles0 = dp.compile_count()
    for _ in range(5):
        db_pack.db_epilogue.launches = 0
        t = time.perf_counter()
        dp.run_many(batch)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t)
    med = sorted(times)[len(times) // 2]
    say("onnx", pages=len(batch), images_per_s_median=f"{len(batch) / med:.3f}",
        images_per_s_best=f"{len(batch) / min(times):.3f}",
        images_per_s_worst=f"{len(batch) / max(times):.3f}",
        run_s=[round(x, 4) for x in times],
        db_epilogue_launches_per_run=db_pack.db_epilogue.launches,
        compile_count=dp.compile_count(), captures_in_timed_region=dp.compile_count() - compiles0)
    if dp.compile_count() != compiles0:
        fail("the timed ONNX runs captured a new graph")
    session.close()

    with onnx_session("compat") as staged:
        t = time.perf_counter()
        res = [staged.run(x) for x in inputs]
        torch.cuda.synchronize()
        run_s = time.perf_counter() - t
        passes = []
        for _ in range(3):
            t = time.perf_counter()
            for x in inputs:
                staged.run(x)
            torch.cuda.synchronize()
            passes.append(time.perf_counter() - t)
    got = _lines(res, range(len(inputs)))
    _per_page("onnx staged", got, len(inputs))
    agree, total, dists = compare("onnx compat", got, fxo["compat_page"], fxo["compat_boxes"],
                                  fxo["compat_texts"])
    frac = agree / max(total, 1)
    say("onnx", staged_compat_lines_agreeing_with_jax=f"{agree}/{total}",
        fraction=f"{frac:.4f}", box_max_px=f"{max(dists, default=0.0):.2f}",
        first_pass_s=f"{run_s:.3f}",
        warm_images_per_s_median=f"{len(inputs) / sorted(passes)[1]:.3f}",
        warm_images_per_s_best=f"{len(inputs) / min(passes):.3f}",
        warm_images_per_s_worst=f"{len(inputs) / max(passes):.3f}")
    if total == 0 or frac < TEXT_MATCH_MIN or max(dists, default=0.0) > BOX_MAX_PX:
        fail(f"ONNX staged: {agree}/{total} lines agree, box {max(dists, default=0.0):.2f} px")
    return launches


def main() -> None:
    if not torch.cuda.is_available():
        print("FAIL: torch.cuda.is_available() is False", flush=True)
        sys.exit(2)
    t0 = time.perf_counter()
    smi, kind = card()
    build()
    k = kernel_phase()
    fx = np.load(ROOT / "retto_tpu_torch" / "testdata" / "smoke_pages.npz")
    launches = e2e_phase(fx)
    stream_phase(fx)
    sessions = {m: mobile_session(m) for m in ("compat", "performance")}
    staged = staged_phase(fx, sessions)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:  # inside the checkout
        cli_phase(fx, staged, kind, Path(tmp))
        serve_launches = serve_phase(fx, sessions, staged, Path(tmp))
    presets_phase()
    train = train_phase()
    onnx_launches = onnx_phase(fx)
    kernel_line = {"kernels": [{
        "name": "db_epilogue",
        "route": "cuda",
        "source": "retto_tpu_torch/csrc/db_pack.cu",
        "replaces": "retto_tpu/ops/pallas/db_pack.py:153",
        "also_replaces": "retto_tpu/ops/pallas/db_pack.py:127",
        "launches": launches,
        "server_launches": serve_launches,
        "onnx_launches": onnx_launches,
        "exact": True,
        "max_abs_err": k["max_abs_err"],
        "ms": k["ms"],
        "host_ms": k["host_ms"],
        "eager_ms": k["eager_ms"],
        "plain_ms": k["plain_ms"],
        "bound_ms": k["bound_ms"],
        "bound_by": "bytes",
        "library_ms": None,
        "mask_only_ms": k["mask_only_ms"],
        "mask_only_host_ms": k["mask_only_host_ms"],
        "mask_only_plain_ms": k["mask_only_plain_ms"],
        "mask_only_bound_ms": k["mask_only_bound_ms"],
        "onnx_shape": list(ONNX_SHAPE),
        "onnx_ms": k["onnx_ms"],
        "onnx_host_ms": k["onnx_host_ms"],
        "onnx_plain_ms": k["onnx_plain_ms"],
        "onnx_bound_ms": k["onnx_bound_ms"],
    }]}
    say("done", total_s=f"{time.perf_counter() - t0:.1f}")
    print("[train] steps_per_s " + json.dumps({k: round(v["steps_per_s_median"], 4)
                                              for k, v in train.items()}), flush=True)
    print(json.dumps(kernel_line), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}),
          flush=True)


if __name__ == "__main__":
    main()
