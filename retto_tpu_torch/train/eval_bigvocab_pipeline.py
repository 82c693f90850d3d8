"""Big-vocab full-pipeline evaluation on PyTorch: det -> cls -> rec end to
end on rendered pseudo-glyph pages with the 6,625-class rec.

Counterpart of ``tools/eval_bigvocab_pipeline.py``, with its argument, its
seed (``0xB16``) and its output lines: the fused ``DevicePipeline.run_many``
over pages of up to 4 pseudo-glyph lines, with ``trained_weights/
rec_big.npz`` and ``charset_big.txt`` standing in for the reference's
ppocr_keys_v1 dict (rec_processor.rs:29-46) and the shipped det and cls.
Reports the per-line exact match, the det line recall and the fully exact
pages at ``n`` lines, and up to 12 MISS lines.  The loop is copied from
that tool, not imported (the port imports nothing of the JAX package).
The glyphs need no fonts (``train.bigvocab``), so the tool runs on the
card's machine too.

    python -m retto_tpu_torch.train.eval_bigvocab_pipeline [n] [--device cuda|cpu]

``--device`` (default ``cuda``, which raises without a card) takes the
place of the JAX tool's ``--tpu``.
"""

from __future__ import annotations

import argparse
import difflib
from dataclasses import dataclass, field
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parents[2]
WEIGHTS = REPO / "trained_weights"
SEED = 0xB16
BATCH = 12


@dataclass
class BigVocabEval:
    """The ground-truth and recognised texts per page, and the tallies the
    tool prints."""

    gts: list[list[str]]
    got: list[list[str]] = field(default_factory=list)
    ok: int = 0
    det_ok: int = 0
    total: int = 0
    pages_all: int = 0
    misses: list[tuple[str, str]] = field(default_factory=list)


def render_pages(n_target: int) -> tuple[list[np.ndarray], list[list[str]]]:
    """Pseudo-glyph pages from the tool's seed until they hold ``n_target``
    lines."""
    from .bigvocab import render_big_page

    rng = np.random.default_rng(SEED)
    pages, gts = [], []
    n_lines = 0
    while n_lines < n_target:
        img, _, texts = render_big_page(rng, 480, 640, max_lines=4,
                                        lh_range=(36, 56), max_len=8)
        if not texts:
            continue
        pages.append(img)
        gts.append(texts)
        n_lines += len(texts)
    return pages, gts


def big_session(device: str):
    """The mobile det and cls with the 6,625-class rec, on ``device``."""
    from ..config import SessionConfig
    from ..ops.charset import CharacterDict
    from ..pipeline.session import RettoSession

    chars = CharacterDict(
        (WEIGHTS / "charset_big.txt").read_text(encoding="utf-8").splitlines()
    )
    return RettoSession(
        SessionConfig(), preset="mobile", charset=chars, device=device,
        weights={
            "det": str(WEIGHTS / "det.npz"),
            "cls": str(WEIGHTS / "cls.npz"),
            "rec": str(WEIGHTS / "rec_big.npz"),
        },
    )


def evaluate(session, n_target: int = 64, log=print) -> BigVocabEval:
    """The tool's loop over ``session``'s fused pipeline, 12 pages a call."""
    pages, gts = render_pages(n_target)
    ev = BigVocabEval(gts)
    dp = session.device_pipeline()
    for lo in range(0, len(pages), BATCH):
        out = dp.run_many(pages[lo : lo + BATCH])
        for res, texts in zip(out, gts[lo:]):
            got = [t.text for t in res.rec_result]
            ev.got.append(got)
            ev.total += len(texts)
            if len(got) == len(texts):
                ev.det_ok += len(texts)
            # align (an extra or missing det box must not shift every later line)
            sm = difflib.SequenceMatcher(a=texts, b=got, autojunk=False)
            page_ok = sum(bl.size for bl in sm.get_matching_blocks())
            ev.ok += page_ok
            matched = set()
            for bl in sm.get_matching_blocks():
                matched.update(range(bl.a, bl.a + bl.size))
            for i, t in enumerate(texts):
                if i not in matched:
                    near = difflib.get_close_matches(t, got, 1, 0.1)
                    ev.misses.append((t, near[0] if near else ""))
            if page_ok == len(texts) and len(got) == len(texts):
                ev.pages_all += 1
        log(f"[big-pipe] {min(lo + BATCH, len(pages))}/{len(pages)} pages: "
            f"exact {ev.ok}/{ev.total}")
    return ev


def agreement(got: list[list[str]], ref: list[list[str]]) -> tuple[int, int]:
    """(lines of ``ref`` that ``got`` reads alike, lines of ``ref``), page
    by page, aligned as the tool aligns a page's lines with its ground
    truth."""
    equal = sum(sum(bl.size for bl in difflib.SequenceMatcher(
        a=r, b=g, autojunk=False).get_matching_blocks()) for g, r in zip(got, ref))
    return equal, sum(len(r) for r in ref)


def summary(ev: BigVocabEval) -> list[str]:
    """The tool's closing lines."""
    total = ev.total
    lines = [f"[big-pipe] pages: {len(ev.gts)}  lines: {total}",
             f"[big-pipe] det boxed-all-lines: {ev.det_ok}/{total}",
             f"[big-pipe] rec exact line match: {ev.ok}/{total} ({ev.ok / max(total, 1):.4f})",
             f"[big-pipe] pages fully exact: {ev.pages_all}/{len(ev.gts)}"]
    return lines + [f"  MISS {t!r} -> {g!r}" for t, g in ev.misses[:12]]


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser(prog="python -m retto_tpu_torch.train.eval_bigvocab_pipeline")
    ap.add_argument("n", nargs="?", type=int, default=64, help="lines to evaluate")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    with big_session(args.device) as session:
        print(f"[big-pipe] {session.chars.num_classes} classes")
        ev = evaluate(session, args.n, log=lambda s: print(s, flush=True))
    for line in summary(ev):
        print(line)


if __name__ == "__main__":
    main()
