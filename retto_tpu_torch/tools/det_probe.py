"""Det forward probe: device time, FLOPs and MFU of the det model and its
variants (port of ``tools/det_probe.py``).

Times, each alone (a captured CUDA graph's replay on the card, the eager
function on the CPU), the best and median of warm calls:

* the mobile det forward at the stride-2 head's raw logits and at the
  full-resolution probability contract;
* ``--variants``: the MobileNetV3 backbone (x0.5) and a stride-1 head;
* the fused ``det_fwd`` as ``DevicePipeline`` runs it (resize + forward +
  the det epilogue kernel + pooled prob map) on gray pages;
* ``--submodules``: the model at batch 16, then backbone, FPN and head
  alone, the backbone on bf16 input and at doubled widths (4x the FLOPs:
  about the same time says bound by bytes, 2x or more by operations);
* ``--v2``: three ``tpu_v2`` backbone configurations at the batch and 16.

FLOPs come from ``utils.flops.cost_of``, MFU from ``utils.flops.mfu``
against ``PEAKS`` (the bf16 peak).  The weights are random (seeded), as
in the JAX tool, unless ``--weights`` names a directory with ``det.npz``.

    python -m retto_tpu_torch.tools.det_probe [--batch 8] [--h 1024] [--w 768]
        [--variants] [--submodules] [--v2] [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
from pathlib import Path

import numpy as np
import torch

from ._common import Row, Timer, add_device_args, card_line, print_rows


def _bf16(module: torch.nn.Module, dev: torch.device) -> torch.nn.Module:
    from ..models.common import cast_compute

    return cast_compute(module, torch.bfloat16).to(dev).eval()


@torch.inference_mode()
def measure(device: str = "cuda", batch: int = 8, h: int = 1024, w: int = 768, iters: int = 5,
            variants: bool = False, submodules: bool = False, v2: bool = False,
            preset: str = "mobile", weights: str | None = None) -> list[Row]:
    from ..models import build_det
    from ..models.dbnet import DetModel

    dev = torch.device(device)
    timer = Timer(dev, iters)
    gen = np.random.default_rng(0)
    torch.manual_seed(0)
    x = torch.from_numpy(gen.uniform(-1, 1, (batch, 3, h, w)).astype(np.float32)).to(dev)

    if v2:
        for label, kw in (("v2-lean w(128,256,384) d(1,1,1)",
                           dict(widths=(128, 256, 384), depths=(1, 1, 1))),
                          ("v2-mid w(128,256,384) d(2,2,2)",
                           dict(widths=(128, 256, 384), depths=(2, 2, 2))),
                          ("v2-wide w(256,384,512) d(1,2,2)",
                           dict(widths=(256, 384, 512), depths=(1, 2, 2)))):
            m = _bf16(DetModel(backbone="tpu_v2", inner_ch=128, head_ch=128, out_stride=2,
                               **kw), dev)
            for bb in (batch, 16):
                xb = torch.from_numpy(gen.uniform(-1, 1, (bb, 3, h, w)).astype(np.float32)
                                      ).to(dev)
                timer(f"{label} (batch {bb})", lambda v, m=m: m(v, raw_logits=True), xb)
        return timer.rows

    det = build_det(preset, compute_dtype="bfloat16")
    if weights is not None:
        from ..weights import load_flax_params, load_params_meta

        flat, _ = load_params_meta(str(Path(weights) / "det.npz"))
        det = load_flax_params(det, flat)
    det = _bf16(det, dev)
    timer(f"{preset} tpu-bb s{det.out_stride} raw (batch {batch})",
          lambda v: det(v, raw_logits=True), x)
    timer(f"{preset} tpu-bb full-res contract", lambda v: det(v), x)

    if variants:
        old = _bf16(DetModel(backbone="mobilenetv3", backbone_scale=0.5, inner_ch=96,
                             head_ch=96, out_stride=2), dev)
        timer("mobilenetv3-bb x0.5 s2 raw", lambda v: old(v, raw_logits=True), x)
        s1 = _bf16(DetModel(widths=(64, 128, 192, 256), depths=(1, 2, 2, 2), inner_ch=128,
                            head_ch=64, out_stride=1), dev)
        timer("tpu-bb s1 (full-res head)", lambda v: s1(v, raw_logits=True), x)

    # the fused det_fwd as the pipeline runs it, on gray pages
    from ._common import session

    with session(device, weights, preset) as s:
        dp = s.device_pipeline()
        ys = torch.from_numpy(gen.integers(0, 255, (batch, 960, 704), np.uint8)).to(dev)
        vs = torch.tensor([[960, 704]] * batch, dtype=torch.int32, device=dev)
        vd = torch.tensor([[992, 736]] * batch, dtype=torch.int32, device=dev)
        timer(f"det_fwd gray fused (resize+fwd+pack+pool, batch {batch})",
              lambda y, a, b: dp._det_fwd((y,), a, b, dh=h, dw=w, fmt="gray"), ys, vs, vd)
        dp.close()

    if submodules:
        _submodules(timer, det, x, batch, h, w, gen)
    return timer.rows


def _submodules(timer: Timer, det, x, batch: int, h: int, w: int, gen) -> None:
    """The model at batch 16, then its backbone, FPN and head alone, the
    backbone on bf16 input and at doubled widths."""
    from ..models.dbnet import TpuBackbone, TpuBackboneV2

    dev = x.device
    x16 = torch.from_numpy(gen.uniform(-1, 1, (16, 3, h, w)).astype(np.float32)).to(dev)
    timer("full det raw, batch 16", lambda v: det(v, raw_logits=True), x16)
    v2 = det.backbone == "tpu_v2"
    bb = det.TpuBackboneV2_0 if v2 else det.TpuBackbone_0
    fpn = det.ConcatFPN_0 if v2 else det.DBFPN_0
    head = det.DBHeadV2_0 if v2 else det.DBHead_0
    xc = x.to(torch.bfloat16)
    timer(f"backbone only (batch {batch})", lambda v: bb(v.to(torch.bfloat16)), x)
    feats = [f.clone() for f in bb(xc)]
    timer("fpn only", lambda *fs: fpn(list(fs)), *feats)
    fused = fpn(feats).clone()
    timer("head only (incl. bilinear logit upsample)", lambda v: head(v), fused)
    timer(f"backbone, bf16 NHWC input (batch {batch})", lambda v: bb(v), xc)
    widths = [getattr(bb, names[0]).Conv_0.out_channels for names in bb.stages]
    depths = [len(names) - 1 for names in bb.stages]
    wide = _bf16((TpuBackboneV2 if v2 else TpuBackbone)([2 * c for c in widths], depths), dev)
    timer(f"backbone 2x widths (batch {batch})", lambda v: wide(v), xc)


def main(argv: list[str] | None = None) -> list[Row]:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--h", type=int, default=1024)
    ap.add_argument("--w", type=int, default=768)
    ap.add_argument("--variants", action="store_true", help="also time backbone variants")
    ap.add_argument("--submodules", action="store_true",
                    help="time backbone/FPN/head separately + width/batch experiments")
    ap.add_argument("--v2", action="store_true",
                    help="time TpuBackboneV2 candidate configs")
    ap.add_argument("--iters", type=int, default=5)
    add_device_args(ap)
    args = ap.parse_args(argv)
    print(card_line(torch.device(args.device)), flush=True)
    print(f"probe shape: [{args.batch}, 3, {args.h}, {args.w}]", flush=True)
    rows = measure(args.device, args.batch, args.h, args.w, args.iters, args.variants,
                   args.submodules, args.v2, args.preset, args.weights)
    print_rows(rows)
    return rows


if __name__ == "__main__":
    main()
