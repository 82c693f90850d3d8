"""Held-out-distribution accuracy evaluation on PyTorch: the shipped
checkpoints on render conditions the synthetic trainer never emits.

Counterpart of ``tools/eval_heldout.py``, with its arguments, its seed
(20260819), its conditions and its output lines: ``size_small`` (font
sizes 20-26), ``size_large`` (48-80), ``offset`` (random position),
``contrast`` (gray on gray, a luminance gap of 60-120), ``noise_jpeg``
(Gaussian noise of sigma 6, then JPEG quality 45), ``font_heldout``
(DejaVu Serif-Bold or Sans Mono-Bold) and ``multiline`` (3-6-line pages
at 480x640).  Per single-line condition: det exactly one box, the box's
corner within 10 px, rec exact, rec exact and cls rot180@0.9 on the page
turned by 180 degrees, and upright pages not turned; per ``multiline``:
pages with every line exact, and lines exact.  Every condition runs
through the fused ``DevicePipeline.run_many``, 16 pages at a time, and up
to 10 MISS lines per condition follow.  The renderer and the loops are
copied from that tool, not imported (the port imports nothing of the JAX
package).  The DejaVu fonts must be installed.

    python -m retto_tpu_torch.train.eval_heldout [n_per_cond] [--conds=a,b,...]
        [--device cuda|cpu]

``--device`` (default ``cuda``, which raises without a card) takes the
place of the JAX tool's ``--tpu``.
"""

from __future__ import annotations

import argparse
import difflib
import io
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parents[2]
WEIGHTS = REPO / "trained_weights"
FONT = "/usr/share/fonts/truetype/dejavu/DejaVuSans.ttf"
CONDS = ["size_small", "size_large", "offset", "contrast", "noise_jpeg", "font_heldout",
         "multiline"]


def render_cond(rng: np.random.Generator, text: str, cond: str) -> tuple[np.ndarray, tuple]:
    """One 640x200 single-line page under the held-out condition."""
    from PIL import Image, ImageDraw, ImageFont

    w, h = 640, 200
    size, xy = 44, (30, 70)
    fg, bg = (0, 0, 0), (255, 255, 255)
    font_path = FONT
    if cond == "font_heldout":
        # faces the trainer never renders (synth's fonts hold Sans,
        # Sans-Bold, Serif, Mono; these two Bold cuts are excluded)
        font_path = rng.choice([
            "/usr/share/fonts/truetype/dejavu/DejaVuSerif-Bold.ttf",
            "/usr/share/fonts/truetype/dejavu/DejaVuSansMono-Bold.ttf",
        ])
    if cond == "size_small":
        size = int(rng.integers(20, 27))
    elif cond == "size_large":
        size = int(rng.integers(48, 81))
    elif cond == "offset":
        xy = (int(rng.integers(4, 200)), int(rng.integers(8, 140)))
    elif cond == "contrast":
        gap = int(rng.integers(60, 121))
        bgl = int(rng.integers(140, 236))
        fgl = bgl - gap
        fg, bg = (fgl,) * 3, (bgl,) * 3
    font = ImageFont.truetype(font_path, size)
    img = Image.new("RGB", (w, h), bg)
    d = ImageDraw.Draw(img)
    d.text(xy, text, font=font, fill=fg)
    box = d.textbbox(xy, text, font=font)
    arr = np.asarray(img, dtype=np.uint8)
    if cond == "noise_jpeg":
        noisy = arr.astype(np.float32) + rng.normal(0, 6, arr.shape)
        arr = np.clip(noisy, 0, 255).astype(np.uint8)
        buf = io.BytesIO()
        Image.fromarray(arr).save(buf, "JPEG", quality=45)
        arr = np.asarray(Image.open(buf).convert("RGB"), np.uint8)
    return arr, box


def eval_single_line(dp, rng, cond: str, n: int, batch: int = 16):
    from .synth import natural_text

    texts = [natural_text(rng, max_words=3) for _ in range(n)]
    pages, bboxes = [], []
    for t in texts:
        img, bb = render_cond(rng, t, cond)
        pages.append(img)
        bboxes.append(bb)
    rot_pages = [p[::-1, ::-1].copy() for p in pages]

    stats = dict(det1=0, box10=0, rec=0, rot_rec=0, cls_rot=0, up_ok=0)
    misses = []
    for lo in range(0, n, batch):
        out = dp.run_many(pages[lo : lo + batch])
        out_r = dp.run_many(rot_pages[lo : lo + batch])
        for k, (res, res_r) in enumerate(zip(out, out_r)):
            i = lo + k
            text, bb = texts[i], bboxes[i]
            if len(res.det_result) == 1:
                stats["det1"] += 1
                br = res.det_result[0].box.br
                if abs(br.x - bb[2]) <= 10 and abs(br.y - bb[3]) <= 10:
                    stats["box10"] += 1
            got = res.rec_result[0].text if res.rec_result.texts else ""
            if got == text:
                stats["rec"] += 1
            else:
                misses.append((cond, text, got))
            cu = res.cls_result
            if cu.labels and not (cu[0].label == 180 and cu[0].score >= 0.9):
                stats["up_ok"] += 1
            cr = res_r.cls_result
            if cr.labels and cr[0].label == 180 and cr[0].score >= 0.9:
                stats["cls_rot"] += 1
            got_r = res_r.rec_result[0].text if res_r.rec_result.texts else ""
            if got_r == text:
                stats["rot_rec"] += 1
    return stats, misses


def eval_multiline(dp, rng, chars, n: int, batch: int = 16):
    """3-6-line pages: det recall (lines boxed), per-line rec exact."""
    from .synth import natural_text, render_page

    stats = dict(lines=0, det=0, rec=0, pages=0, pages_all=0)
    misses = []
    pages, gts = [], []
    for _ in range(n):
        img, boxes, texts = render_page(
            rng, chars, h=480, w=640, max_lines=6, lh_range=(24, 48),
            text_fn=lambda r: natural_text(r, max_words=3),
        )
        if len(texts) < 3:  # force the held-out 3-6-line regime
            continue
        pages.append(img)
        gts.append(texts)
    for lo in range(0, len(pages), batch):
        out = dp.run_many(pages[lo : lo + batch])
        for res, texts in zip(out, gts[lo:]):
            got = [t.text for t in res.rec_result]
            stats["pages"] += 1
            stats["lines"] += len(texts)
            stats["det"] += min(len(got), len(texts))
            # align the ground-truth lines to the predicted ones (det may
            # emit extra or missing boxes; a plain zip shifts every later line)
            sm = difflib.SequenceMatcher(a=texts, b=got, autojunk=False)
            ok = sum(bl.size for bl in sm.get_matching_blocks())
            stats["rec"] += ok
            if ok == len(texts) and len(got) == len(texts):
                stats["pages_all"] += 1
            else:
                matched_a = set()
                for bl in sm.get_matching_blocks():
                    matched_a.update(range(bl.a, bl.a + bl.size))
                for i, t in enumerate(texts):
                    if i not in matched_a:
                        near = difflib.get_close_matches(t, got, 1, 0.3)
                        misses.append(("multiline", t, near[0] if near else ""))
    return stats, misses


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser(prog="python -m retto_tpu_torch.train.eval_heldout")
    ap.add_argument("n", nargs="?", type=int, default=64, help="pages per condition")
    ap.add_argument("--conds", default=",".join(CONDS),
                    help="comma-separated conditions (default: all)")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    n, conds = args.n, args.conds.split(",")

    from ..config import SessionConfig
    from ..ops.charset import CharacterDict
    from ..pipeline.session import RettoSession

    chars = CharacterDict(
        (WEIGHTS / "charset.txt").read_text(encoding="utf-8").splitlines()
    )
    session = RettoSession(
        SessionConfig(), preset="mobile", charset=chars, device=args.device,
        weights={k: str(WEIGHTS / f"{k}.npz") for k in ("det", "cls", "rec")},
    )
    rng = np.random.default_rng(20260819)

    print(f"held-out eval, n={n} per condition")
    print(f"{'condition':<12} {'det1':>9} {'box10':>9} {'rec':>9} "
          f"{'rot-rec':>9} {'cls-rot':>9} {'up-ok':>9}")
    all_misses = []
    with session:
        dp = session.device_pipeline()
        for cond in conds:
            if cond == "multiline":
                st, misses = eval_multiline(dp, rng, chars, n)
                print(f"{cond:<12} boxes-exact pages {st['pages_all']}/{st['pages']}"
                      f"  line-rec {st['rec']}/{st['lines']}", flush=True)
            else:
                st, misses = eval_single_line(dp, rng, cond, n)
                print(f"{cond:<12} {st['det1']:>5}/{n:<3} {st['box10']:>5}/{n:<3} "
                      f"{st['rec']:>5}/{n:<3} {st['rot_rec']:>5}/{n:<3} "
                      f"{st['cls_rot']:>5}/{n:<3} {st['up_ok']:>5}/{n:<3}", flush=True)
            all_misses.extend(misses[:10])
    for cond, t, g in all_misses:
        print(f"  MISS [{cond}] {t!r} -> {g!r}")


if __name__ == "__main__":
    main()
