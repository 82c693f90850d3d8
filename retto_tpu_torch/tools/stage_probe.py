"""Per-stage device time of ``DevicePipeline.run_many`` (port of
``tools/stage_probe.py``).

Breaks bench.py's config 3 down: 16 pages of 960x704 (the fixture pages,
``testdata/smoke_pages.npz``), det chunks of 4 in a 1024x768 bucket,
``yuv420`` transfer.  A warm ``run_many`` records every call it makes
through the captured graphs; each is then replayed alone, synchronised,
with the host stages around them:

* ``upload``: one chunk's planes to the card (pinned staging buffers);
* ``det_fwd``: resize + det forward + the det epilogue kernel, per chunk;
* ``mask fetch``: the packed mask and pooled prob map to the host;
* ``score_fwd (64 cands)``: the box score of 64 candidates (on the host
  in the port, ``_score_candidates`` in numpy; on the device in JAX), and
  the host postprocess the pipeline runs per chunk instead (contours, box
  score and unclip in one native call, ``det_chunk_native``);
* ``clsrec_fwd``: each cls + rec bucket of the run, and the JAX tool's 32
  crops at width 512 (identity geometry, the gather warp);
* ``clsrec fetch``: a bucket's results to the host.

The device stages of one call (det per chunk, each bucket) add up to at
most the call's wall time, which ``run_many`` is timed for too.

    python -m retto_tpu_torch.tools.stage_probe [yuv420|rgb] [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
from collections import Counter

import numpy as np
import torch

from ..utils.timing import StageTimers
from ._common import (
    WEIGHTS, Row, add_device_args, card_line, fixture_pages, flops_of, measure_row,
    print_rows, session,
)


def _recording(dp) -> list:
    """Wrap the pipeline's graph caches: each call leaves (cache, key, fn,
    cloned args)."""
    calls = []
    for cache in (dp._det_graphs, dp._clsrec_graphs):
        def run(key, fn, *args, _run=cache.run, _cache=cache):
            calls.append((_cache, key, fn, [a.clone() for a in args]))
            return _run(key, fn, *args)
        cache.run = run
    return calls


def _stop(dp) -> None:
    for cache in (dp._det_graphs, dp._clsrec_graphs):
        del cache.run


@torch.inference_mode()
def measure(device: str = "cuda", weights: str | None = str(WEIGHTS),
            transfer: str = "yuv420", pages: int = 16, chunk: int = 4,
            size: tuple[int, int] | None = None, iters: int = 5, crops: int = 32,
            width: int = 512, preset: str = "mobile") -> tuple[list[Row], dict]:
    """The rows, and {"wall_ms": run_many's best, "device_sum_ms": the sum
    of one call's device stages, "det_chunks", "buckets"}."""
    from ..native import det_chunk_native
    from ..pipeline.device_pipeline import _score_candidates

    dev = torch.device(device)
    rows: list[Row] = []
    with session(device, weights, preset, transfer) as s:
        s.config.buckets.det_chunk = chunk
        dp = s.device_pipeline()
        rep = dp._shards[0]
        batch = fixture_pages(pages, size)
        dp.run_many(batch)  # captures every graph of the call
        calls = _recording(dp)
        dp.run_many(batch)
        _stop(dp)
        rows.append(measure_row(f"run_many ({pages} pages)", lambda: dp.run_many(batch), dev,
                                iters, kind="wall"))

        dets = [c for c in calls if c[0] is dp._det_graphs]
        cache, key, fn, args = dets[0]
        first = dets[0]
        packed, prob, rgb = (t.clone() for t in cache.run(key, fn, *args))
        # upload: one chunk's host planes, decoded as the pipeline does
        planes = [np.stack(p) for p in zip(*(dp._decode_one(page)[1]
                                             for page in batch[:args[0].shape[0]]))]
        mb = sum(p.nbytes for p in planes) / 1e6
        rows.append(measure_row(f"upload {mb:.1f}MB",
                                lambda: [dp._put(p, rep) for p in planes], dev, iters,
                                kind="transfer", per_call=len(dets)))
        for (key, nb), n in Counter((c[1], c[3][0].shape[0]) for c in dets).items():
            _, _, fn, args = next(c for c in dets if c[1] == key)
            rows.append(measure_row(
                f"det_fwd (resize+det+binarize, batch {nb})",
                lambda fn=fn, args=args, key=key: dp._det_graphs.run(key, fn, *args), dev,
                iters, flops_of(fn, *args), per_call=n))
        mb = (packed.numel() * packed.element_size() + prob.numel() * prob.element_size()) / 1e6
        rows.append(measure_row(f"mask fetch {mb:.2f}MB",
                                lambda: dp._fetch_det([dp._to_host((packed, prob))], 0, 0), dev, iters,
                                kind="transfer", per_call=len(dets)))
        prob_np = prob[0].cpu().numpy()
        h, w = (4 * n for n in prob_np.shape)  # the det canvas the quads live on
        rng = np.random.default_rng(0)
        quads = []
        for _ in range(64):
            x0, y0 = rng.uniform(0, w * 0.8), rng.uniform(0, h * 0.9)
            quads.append([[x0, y0], [x0 + w * 0.15, y0], [x0 + w * 0.15, y0 + h * 0.05],
                          [x0, y0 + h * 0.05]])
        quads = np.asarray(quads, np.float32)
        rows.append(measure_row("score_fwd (64 cands)", lambda: _score_candidates(prob_np, quads),
                                dev, iters, kind="host", per_call=0))
        # what the pipeline runs on the host per chunk: contours, the box
        # score and the unclip in one native call (rt_det_chunk)
        stride = dp._det_stride
        dh, dw = first[1][1:3]
        packed_np, prob_all = packed.cpu().numpy(), prob.cpu().numpy()
        nb = packed_np.shape[0]
        det = dp.cfg.det

        def chunk_post():
            return det_chunk_native(
                packed_np, packed_np.shape[1] != dh // stride, prob_all,
                [(dh // stride, dw // stride)] * nb, stride, [(dh, dw)] * nb, [(dh, dw)] * nb,
                max(1, det.min_mini_box_size // stride), det.max_candidates, det.box_thresh,
                det.unclip_ratio, det.min_mini_box_size)

        if chunk_post() is not None:
            rows.append(measure_row(f"det_chunk host postprocess (batch {nb})", chunk_post, dev,
                                    iters, kind="host", per_call=len(dets)))

        buckets = [c for c in calls if c[0] is dp._clsrec_graphs]
        for key, n in Counter(c[1] for c in buckets).items():
            _, _, fn, args = next(c for c in buckets if c[1] == key)
            kind = "" if key[4] else ", gather warp"  # key: (image, batch, width, cls, aligned)
            rows.append(measure_row(
                f"clsrec_fwd ({args[1].shape[0]} crops, w{key[2]}{kind})",
                lambda fn=fn, args=args, key=key: dp._clsrec_graphs.run(key, fn, *args),
                dev, iters, flops_of(fn, *args), per_call=n))
        # the JAX tool's row: identity geometry over the first chunk's image
        eye = torch.eye(3, device=dev).expand(crops, 3, 3).contiguous()
        vs = first[3][-2]
        syn = (rgb, torch.zeros(crops, dtype=torch.long, device=dev), eye, eye,
               torch.full((crops,), 192, dtype=torch.int32, device=dev), eye, eye,
               torch.full((crops,), width, dtype=torch.int32, device=dev), vs)
        skey = ("probe", tuple(rgb.shape), crops, width)

        def syn_fn(*t):
            return dp._clsrec_fwd(*t, out_w=width, use_cls=True, rep=rep)

        rows.append(measure_row(f"clsrec_fwd ({crops} crops, w{width})",
                                lambda: dp._clsrec_graphs.run(skey, syn_fn, *syn), dev, iters,
                                flops_of(syn_fn, *syn), per_call=0))
        out = dp._clsrec_graphs.run(skey, syn_fn, *syn)
        rows.append(measure_row(
            "clsrec fetch", lambda: dp._host([dp._to_host(out)], StageTimers(), "clsrec_wait",
                                             "clsrec_device"),
            dev, iters, kind="transfer", per_call=0))
        x = torch.zeros((first[3][0].shape[0], *first[1][1:3], 3), dtype=dp._det_dtype,
                        device=dev)
        model_flops = flops_of(lambda v: rep.det(v, nhwc=True, raw_logits=True), x)
        dp.close()
    device_sum = sum(r.ms * r.per_call for r in rows if r.kind == "device")
    return rows, {"wall_ms": rows[0].ms, "device_sum_ms": device_sum,
                  "det_chunks": len(dets), "buckets": len(buckets),
                  "det_model_flops": model_flops}


def main(argv: list[str] | None = None) -> list[Row]:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("transfer", nargs="?", default="yuv420", choices=("yuv420", "rgb"))
    add_device_args(ap)
    ap.set_defaults(weights=str(WEIGHTS))
    ap.add_argument("--pages", type=int, default=16)
    ap.add_argument("--chunk", type=int, default=4)
    ap.add_argument("--size", default=None, help="HxW of the pages (default 960x704)")
    ap.add_argument("--iters", type=int, default=5)
    ap.add_argument("--crops", type=int, default=32)
    ap.add_argument("--width", type=int, default=512)
    args = ap.parse_args(argv)
    size = tuple(int(v) for v in args.size.split("x")) if args.size else None
    print(card_line(torch.device(args.device)), flush=True)
    rows, info = measure(args.device, args.weights, args.transfer, args.pages, args.chunk,
                         size, args.iters, args.crops, args.width, args.preset)
    print_rows(rows)
    print(f"det model flops (batch {args.chunk}): {info['det_model_flops'] / 1e9:.1f} GFLOP",
          flush=True)
    print(f"device stages of one call: {info['device_sum_ms']:.3f} ms "
          f"({info['det_chunks']} det chunks, {info['buckets']} cls+rec buckets) "
          f"against run_many {info['wall_ms']:.3f} ms", flush=True)
    return rows


if __name__ == "__main__":
    main()
