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
   launches, host time per wrapper call, beside its memory bound;
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
5. a JSON line ``{"kernels": [...]}`` and, last, the JSON line
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
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch
from scipy import ndimage

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT))

from retto_tpu_torch import RettoSession, SessionConfig  # noqa: E402
from retto_tpu_torch import kernels, native  # noqa: E402
from retto_tpu_torch.ops import db_pack  # noqa: E402
from retto_tpu_torch.ops.charset import CharacterDict  # noqa: E402
from retto_tpu_torch.pipeline.device_pipeline import _is_aligned  # noqa: E402

HBM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3 (NVIDIA data sheet)
MAIN_SHAPE = (4, 512, 384)  # det chunk 4 x stride-2 logits of a 1024x768 bucket
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


def e2e_phase(fx) -> int:
    """Drive the main path, hold it to the fixture, time warm runs; returns
    the db_epilogue launches of the main-path call."""
    chars = CharacterDict((ROOT / "trained_weights" / "charset.txt").read_text().splitlines())
    weights = {k: str(ROOT / "trained_weights" / f"{k}.npz") for k in ("det", "cls", "rec")}
    t = time.perf_counter()
    cfg = SessionConfig()
    cfg.engine.transfer_format = "yuv420"
    session = RettoSession(cfg, preset="mobile", charset=chars, weights=weights,
                           device="cuda")
    dp = session.device_pipeline()
    say("e2e", session_build_s=f"{time.perf_counter() - t:.2f}")
    pages = [np.repeat(p[..., None], 3, axis=2) for p in fx["pages"]]
    tint = fx["tint"].astype(np.float32)

    def tinted_page(i):
        return np.rint(fx["pages"][i][..., None].astype(np.float32) * tint).astype(np.uint8)

    tinted = tinted_page(0)
    rotated = ndimage.rotate(tinted_page(2), float(fx["rotate_deg"]), reshape=False,
                             order=1, cval=255)

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

    cfg_rgb = SessionConfig()
    cfg_rgb.engine.transfer_format = "rgb"
    dp_rgb = RettoSession(cfg_rgb, preset="mobile", charset=chars, weights=weights,
                          device="cuda").device_pipeline()
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
    chars = CharacterDict((ROOT / "trained_weights" / "charset.txt").read_text().splitlines())
    weights = {k: str(ROOT / "trained_weights" / f"{k}.npz") for k in ("det", "cls", "rec")}
    cfg = SessionConfig()
    cfg.engine.transfer_format = "yuv420"
    with RettoSession(cfg, preset="mobile", charset=chars, weights=weights,
                      device="cuda") as session:
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
    kernel_line = {"kernels": [{
        "name": "db_epilogue",
        "route": "cuda",
        "source": "retto_tpu_torch/csrc/db_pack.cu",
        "replaces": "retto_tpu/ops/pallas/db_pack.py:153",
        "also_replaces": "retto_tpu/ops/pallas/db_pack.py:127",
        "launches": launches,
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
    }]}
    say("done", total_s=f"{time.perf_counter() - t0:.1f}")
    print(json.dumps(kernel_line), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}),
          flush=True)


if __name__ == "__main__":
    main()
