"""Accuracy evaluation against the reference's own oracle bar on PyTorch
(session.rs:206-255): exact text, the box's bottom-right corner within
10 px of the text extent, and the cls label at thresh 0.9, upright and
turned by 180 degrees.

Counterpart of ``tools/eval_accuracy.py``, with its arguments, its seed
(123) and its output lines, every MISS, CLS and DET line included: ``n``
fresh single-line pages rendered with DejaVu Sans 44 at (30, 70), through
the staged ``RettoSession.run`` or, with ``--fused``, the same render
stream through ``DevicePipeline.run_many`` 16 pages at a time.  The
renderer and the loop are copied from that tool, not imported (the port
imports nothing of the JAX package).  The DejaVu fonts must be installed.

    python -m retto_tpu_torch.train.eval_accuracy [n] [--fused] [--device cuda|cpu]

``--device`` (default ``cuda``, which raises without a card) takes the
place of the JAX tool's ``--tpu``.
"""

from __future__ import annotations

import argparse
import difflib
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parents[2]
WEIGHTS = REPO / "trained_weights"
FONT = "/usr/share/fonts/truetype/dejavu/DejaVuSans.ttf"


def render(text: str, w=640, h=200, size=44, xy=(30, 70)):
    """One white 640x200 page with ``text``; (page, its ink box l, t, r, b)."""
    from PIL import Image, ImageDraw, ImageFont

    font = ImageFont.truetype(FONT, size)
    img = Image.new("RGB", (w, h), (255, 255, 255))
    d = ImageDraw.Draw(img)
    d.text(xy, text, font=font, fill=(0, 0, 0))
    box = d.textbbox(xy, text, font=font)
    return np.asarray(img, dtype=np.uint8), box


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser(prog="python -m retto_tpu_torch.train.eval_accuracy")
    ap.add_argument("n", nargs="?", type=int, default=32, help="pages to render")
    ap.add_argument("--fused", action="store_true",
                    help="the fused DevicePipeline.run_many in batches of 16")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    n, fused = args.n, args.fused

    from ..config import SessionConfig
    from ..ops.charset import CharacterDict
    from ..pipeline.session import RettoSession
    from .synth import natural_text

    chars = CharacterDict(
        (WEIGHTS / "charset.txt").read_text(encoding="utf-8").splitlines()
    )
    cfg = SessionConfig()  # reference defaults incl. cls.thresh 0.9
    session = RettoSession(
        cfg, preset="mobile", charset=chars, device=args.device,
        weights={k: str(WEIGHTS / f"{k}.npz") for k in ("det", "cls", "rec")},
    )
    rng = np.random.default_rng(123)
    with session:
        if fused:
            texts_all, pages, bboxes = [], [], []
            for _ in range(n):
                t = natural_text(rng, max_words=3)
                img, bb = render(t)
                texts_all.append(t)
                pages.append(img)
                bboxes.append(bb)
            dp = session.device_pipeline()
            results, results_r = [], []
            bsz = 16
            for lo in range(0, n, bsz):
                chunk = pages[lo : lo + bsz]
                results.extend(dp.run_many(chunk))
                results_r.extend(dp.run_many([p[::-1, ::-1].copy() for p in chunk]))
                if (lo + bsz) % 128 == 0:
                    print(f"[fused] {min(lo + bsz, n)}/{n}", flush=True)

        n_exact = n_close = n_box = n_cls_up = n_cls_rot = n_det1 = 0
        n_up_norot = n_rot_text = 0
        fails = []
        cls_fails = []
        det_fails = []
        for i in range(n):
            if fused:
                text, img, bbox = texts_all[i], pages[i], bboxes[i]
                res = results[i]
            else:
                text = natural_text(rng, max_words=3)
                img, bbox = render(text)
                res = session.run(img)
            if len(res.det_result) == 1:
                n_det1 += 1
                br = res.det_result[0].box.br
                if abs(br.x - bbox[2]) <= 10 and abs(br.y - bbox[3]) <= 10:
                    n_box += 1
                else:
                    det_fails.append((text, "BR", (br.x, br.y), (bbox[2], bbox[3])))
            else:
                det_fails.append((text, "NBOX", len(res.det_result), None))
            got = res.rec_result[0].text if res.rec_result.texts else ""
            if got == text:
                n_exact += 1
            else:
                fails.append((text, got))
            if difflib.SequenceMatcher(None, got, text).ratio() >= 0.9:
                n_close += 1
            cu = res.cls_result
            if cu.labels and cu[0].label == 0:
                n_cls_up += 1
            # functional criterion: the pipeline only rotates when label==180
            # AND score>=thresh (cls_processor.rs:81-90); an upright crop is
            # handled correctly iff no rotation fires
            if cu.labels and not (cu[0].label == 180 and cu[0].score >= 0.9):
                n_up_norot += 1
            elif cu.labels:
                cls_fails.append(("UP", text, cu[0].label, cu[0].score))
            res_r = results_r[i] if fused else session.run(img[::-1, ::-1].copy())
            cr = res_r.cls_result
            if cr.labels and cr[0].label == 180 and cr[0].score >= 0.9:
                n_cls_rot += 1
            else:
                cls_fails.append(("ROT", text, cr[0].label if cr.labels else None,
                                  cr[0].score if cr.labels else None))
            # end-to-end rotated text: the metric the cls stage exists to serve
            got_r = res_r.rec_result[0].text if res_r.rec_result.texts else ""
            if got_r == text:
                n_rot_text += 1
            if (i + 1) % 64 == 0:
                print(f"[{i + 1}/{n}] rec {n_exact}/{i + 1} "
                      f"rot-rec {n_rot_text}/{i + 1} cls-rot {n_cls_rot}/{i + 1}", flush=True)
    print(f"n={n}  mode={'fused-run_many' if fused else 'staged-session.run'}")
    print(f"det exactly-1-box: {n_det1}/{n}")
    print(f"box BR within 10px: {n_box}/{n}")
    print(f"rec exact: {n_exact}/{n}  (>=0.9 sim: {n_close}/{n})")
    print(f"rec exact on 180-rotated input: {n_rot_text}/{n}")
    print(f"cls strict-label upright: {n_cls_up}/{n}  rot180@0.9: {n_cls_rot}/{n}")
    print(f"cls functional (upright not rotated): {n_up_norot}/{n}")
    for t, g in fails:
        print(f"  MISS {t!r} -> {g!r}")
    for kind, t, lb, sc in cls_fails:
        print(f"  CLS-{kind} {t!r} -> label={lb} score={sc}")
    for t, kind, got, want in det_fails:
        print(f"  DET-{kind} {t!r} -> {got} (want {want})")


if __name__ == "__main__":
    main()
