"""Cls + rec chain breakdown probe (port of ``tools/clsrec_probe.py``).

Times, each alone on tensors already on the device (a captured CUDA
graph's replay on the card, the eager function on the CPU), the best and
median of warm calls:

* the fused ``_clsrec_fwd`` of ``DevicePipeline`` at the JAX tool's
  geometry (``--n`` crops, width 320, the separable warp), then with
  ``use_cls`` off, then with ``ClsConfig.symmetrize`` off;
* the cls forward alone, the rec forward alone and the rec with the CTC
  greedy decode, on seeded inputs;
* the separable warp alone (``image.warp.warp_crops_separable``) at the
  rec's 48x320 and the cls's 48x192.

FLOPs come from ``utils.flops.cost_of``, MFU from ``utils.flops.mfu``.
The weights are random (seeded), as in the JAX tool, unless ``--weights``
names a directory of checkpoints.

    python -m retto_tpu_torch.tools.clsrec_probe [--n 32] [--iters 30] [--device cuda|cpu]
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from ._common import Row, Timer, add_device_args, card_line, print_rows, session


def _geometry(n: int, dev: torch.device) -> dict[str, torch.Tensor]:
    """The JAX tool's crop geometry: (ox, sx, oy, sy) per crop."""
    def rows(v):
        return torch.tensor(np.tile([v], (n, 1)).astype(np.float32), device=dev)

    return {"rec": rows([8.0, 600.0 / 320.0, 100.0, 32.0 / 48.0]),
            "rec_flip": rows([608.0, -600.0 / 320.0, 132.0, -32.0 / 48.0]),
            "cls": rows([8.0, 600.0 / 192.0, 100.0, 32.0 / 48.0]),
            "cls_flip": rows([608.0, -600.0 / 192.0, 132.0, -32.0 / 48.0])}


@torch.inference_mode()
def measure(device: str = "cuda", n: int = 32, iters: int = 30, preset: str = "mobile",
            weights: str | None = None) -> list[Row]:
    from ..image.warp import warp_crops_separable
    from ..ops.ctc import ctc_greedy_decode

    dev = torch.device(device)
    timer = Timer(dev, iters)
    b = 8
    gen = np.random.default_rng(1)
    geo = _geometry(n, dev)
    rows_t = torch.arange(n, device=dev) % b
    w_rec = torch.full((n,), 320, dtype=torch.int32, device=dev)
    w_cls = torch.full((n,), 192, dtype=torch.int32, device=dev)
    with session(device, weights, preset) as s, \
            session(device, weights, preset, symmetrize=False) as s2:
        dp, dp2 = s.device_pipeline(), s2.device_pipeline()
        ys = torch.from_numpy(gen.integers(0, 255, (b, 960, 704), np.uint8)).to(dev)
        vs = torch.tensor([[960, 704]] * b, dtype=torch.int32, device=dev)
        vd = torch.tensor([[992, 736]] * b, dtype=torch.int32, device=dev)
        _, _, rgb = dp._det_fwd((ys,), vs, vd, dh=1024, dw=768, fmt="gray")
        args = (rgb, rows_t, geo["cls"], geo["cls_flip"], w_cls, geo["rec"], geo["rec_flip"],
                w_rec, vs)

        def clsrec(pipe, use_cls):
            return lambda *t: pipe._clsrec_fwd(*t, out_w=320, use_cls=use_cls)

        timer(f"clsrec_fwd full (n={n}, sym=on)", clsrec(dp, True), *args)
        timer(f"clsrec_fwd rec-only (n={n})", clsrec(dp, False), *args)
        timer(f"clsrec_fwd full (n={n}, sym=OFF)", clsrec(dp2, True), *args)

        rep = dp._shards[0]
        xc = torch.from_numpy(gen.uniform(-1, 1, (n, 3, 48, 192)).astype(np.float32)).to(dev)
        xr = torch.from_numpy(gen.uniform(-1, 1, (n, 3, 48, 320)).astype(np.float32)).to(dev)
        timer(f"cls fwd alone (n={n})", lambda v: rep.cls(v), xc)
        timer(f"rec fwd alone (n={n})", lambda v: rep.rec(v), xr)
        timer(f"rec fwd + ctc (n={n})", lambda v: ctc_greedy_decode(rep.rec(v)), xr)
        vhw = torch.tensor([[960, 704]] * b, dtype=torch.int32, device=dev)
        timer(f"separable warp rec 48x320 (n={n})",
              lambda img, r, g, v: warp_crops_separable(img, r, g, v, 48, 320),
              rgb, rows_t, geo["rec"], vhw)
        timer(f"separable warp cls 48x192 (n={n})",
              lambda img, r, g, v: warp_crops_separable(img, r, g, v, 48, 192),
              rgb, rows_t, geo["cls"], vhw)
        dp.close()
        dp2.close()
    return timer.rows


def main(argv: list[str] | None = None) -> list[Row]:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n", type=int, default=32)
    ap.add_argument("--iters", type=int, default=30)
    add_device_args(ap)
    args = ap.parse_args(argv)
    print(card_line(torch.device(args.device)), flush=True)
    print(f"n={args.n}", flush=True)
    rows = measure(args.device, args.n, args.iters, args.preset, args.weights)
    print_rows(rows)
    for r in rows:
        print(f"  {r.label}: {r.ms / args.n * 1e3:.1f} us/crop", flush=True)
    return rows


if __name__ == "__main__":
    main()
