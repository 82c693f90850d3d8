"""The one page generator: a traffic mix (a JSON file of parameters beside
this module) and a seed in, the pages of a run out.

Pages are black text on white, composed from the glyph bank
(``bank.npz``, see ``make_bank.py``) in NumPy, so the same seed gives the
same pages on any machine.  A line follows ``train/synth.py::render_page``
of the port: text of up to ``chars`` characters drawn from the charset,
split into one to three words; the line's ink cropped, scaled to the line
height less 8 px and padded by 4 px of paper on each side.

Layouts (``pages.layout``):

* ``"lines"``: ``lines`` = [lo, hi] lines a page, each ``line_height``
  = [lo, hi] px tall, one under the other with ``gap`` = [lo, hi] px
  between them, starting at a random height in the upper 60% of the page
  (lower where the lines would not fit), each at a random x;
* ``"rows"``: the page filled from the top with rows ``line_height`` px
  tall and ``gap`` px apart, ``per_row`` lines a row at least
  ``min_apart`` px apart.

How many lines each page of the pool gets is a fixed list spread evenly
over ``lines`` and shuffled by the seed, so every seed makes the same
amount of work in another order.  The harness drives the pages in
``batch``-page calls, ``pool_batches`` batches taken in turn.
"""

from __future__ import annotations

import json
from pathlib import Path

import numpy as np

__all__ = ["Bank", "load_mix", "make_pool", "page_sizes"]

HERE = Path(__file__).resolve().parent
PAD = 4


def load_mix(name: str) -> dict:
    """The traffic mix ``name`` (``traffic/<name>.json``)."""
    path = HERE / f"{name}.json"
    if not path.is_file():
        raise FileNotFoundError(f"no traffic mix {name!r} ({path})")
    return json.loads(path.read_text())


class Bank:
    """The rendered glyphs (``bank.npz``)."""

    def __init__(self, path: Path = HERE / "bank.npz"):
        with np.load(path, allow_pickle=False) as z:
            self.tiles = z["tiles"].astype(np.float32)
            self.advance = z["advance"].astype(np.float64)
            chars = [str(c) for c in z["chars"]]
        self.index = {c: k for k, c in enumerate(chars)}
        self.chars = chars[:-1]  # the charset; the last glyph is the space
        self.pad = 8  # make_bank.PAD

    def line(self, text: str, height: int) -> np.ndarray:
        """Ink coverage [height, width] float32 in [0, 255] of one line."""
        ks = [self.index[c] for c in text]
        pens = np.concatenate([[0.0], np.cumsum(self.advance[ks])])
        band, tw = self.tiles.shape[1], self.tiles.shape[2]
        width = int(np.ceil(pens[-1])) + tw
        ink = np.zeros((band, width), np.float32)
        for k, x in zip(ks, pens[:-1]):
            x0 = int(round(x))
            ink[:, x0:x0 + tw] = np.maximum(ink[:, x0:x0 + tw], self.tiles[k])
        rows = np.nonzero(ink.max(axis=1) > 0)[0]
        cols = np.nonzero(ink.max(axis=0) > 0)[0]
        if not len(rows):
            return np.zeros((height, 2 * PAD + 1), np.float32)
        ink = ink[rows[0]:rows[-1] + 1, cols[0]:cols[-1] + 1]
        inner = height - 2 * PAD
        out_w = max(int(round(ink.shape[1] * inner / ink.shape[0])), 1)
        scaled = _resize(ink, inner, out_w)
        return np.pad(scaled, PAD)


def _resize_axis(img: np.ndarray, dst: int, axis: int) -> np.ndarray:
    """Bilinear resample of ``img`` along ``axis`` to ``dst`` samples, with
    pixel centres and the triangle widened by the scale on a downscale."""
    src = img.shape[axis]
    scale = src / dst
    support = max(scale, 1.0)
    pos = (np.arange(dst) + 0.5) * scale - 0.5
    taps = 2 * int(np.ceil(support)) + 1
    idx = np.floor(pos - support).astype(np.int64)[:, None] + 1 + np.arange(taps)[None, :]
    w = np.maximum(1.0 - np.abs(pos[:, None] - idx) / support, 0.0)
    w = np.where((idx >= 0) & (idx < src), w, 0.0)
    w = (w / w.sum(axis=1, keepdims=True)).astype(np.float32)
    src_view = np.moveaxis(img, axis, -1)[..., np.clip(idx, 0, src - 1)]  # [..., dst, taps]
    return np.moveaxis((src_view * w).sum(axis=-1), -1, axis)


def _resize(img: np.ndarray, h: int, w: int) -> np.ndarray:
    return _resize_axis(_resize_axis(img, h, 0), w, 1).astype(np.float32)


def _text(rng: np.random.Generator, chars: list[str], max_len: int) -> str:
    """``train/synth.py::random_text``: 1..max_len characters, split into
    one to three words from four characters on."""
    n = int(rng.integers(1, max_len + 1))
    body = "".join(rng.choice(chars, size=n))
    if n < 4:
        return body
    k = int(rng.integers(0, 3))
    pos = sorted(rng.choice(np.arange(1, n), size=k, replace=False)) if k else []
    parts, last = [], 0
    for p in pos:
        parts.append(body[last:p])
        last = p
    parts.append(body[last:])
    return " ".join(parts)


def _paste(page: np.ndarray, ink: np.ndarray, x: int, y: int, lines: list) -> None:
    h, w = ink.shape
    w = min(w, page.shape[1] - x)
    region = page[y:y + h, x:x + w]
    np.minimum(region, 255.0 - ink[:, :w], out=region)
    lines.append((x, y, x + w, y + h))


def _page_lines(rng, bank: Bank, h: int, w: int, n_lines: int, p: dict, lines: list
                ) -> np.ndarray:
    page = np.full((h, w), 255.0, np.float32)
    lo, hi = p["line_height"]
    glo, ghi = p["gap"]
    heights = rng.integers(lo, hi + 1, size=n_lines)
    gaps = rng.integers(glo, ghi + 1, size=n_lines)
    total = int(heights.sum() + gaps[:-1].sum())
    y = int(rng.integers(4, max(5, min(int(h * 0.6), h - total - 4))))
    for lh, gap in zip(heights, gaps):
        ink = bank.line(_text(rng, bank.chars, p["chars"]), int(lh))
        lw = min(ink.shape[1], w - 8)
        x = int(rng.integers(2, max(3, w - lw - 2)))
        if y + lh >= h:
            break
        _paste(page, ink[:, :lw], x, y, lines)
        y += int(lh + gap)
    return page


def _page_rows(rng, bank: Bank, h: int, w: int, p: dict, lines: list) -> np.ndarray:
    page = np.full((h, w), 255.0, np.float32)
    lo, hi = p["line_height"]
    glo, ghi = p["gap"]
    y = int(rng.integers(4, 4 + ghi))
    while True:
        lh = int(rng.integers(lo, hi + 1))
        if y + lh >= h - 4:
            break
        x = int(rng.integers(2, 2 + p["min_apart"]))
        for _ in range(p["per_row"]):
            text = _text(rng, bank.chars, p["chars"])
            ink = bank.line(text, lh)
            while text and x + ink.shape[1] > w - 2:
                text = text[:-1].rstrip()
                ink = bank.line(text, lh)
            if not text:
                break
            _paste(page, ink, x, y, lines)
            x += ink.shape[1] + p["min_apart"] + int(rng.integers(0, p["min_apart"]))
        y += lh + int(rng.integers(glo, ghi + 1))
    return page


def page_sizes(mix: dict, n: int, rng: np.random.Generator) -> list[tuple[int, int]]:
    """n (h, w) sizes in equal shares of the mix's sizes, shuffled."""
    sizes = [tuple(s) for s in mix["pages"]["sizes"]]
    out = [sizes[i % len(sizes)] for i in range(n)]
    return [out[i] for i in rng.permutation(n)]


def make_pool(mix: dict, seed: int, bank: Bank | None = None,
              lines: list | None = None) -> list[np.ndarray]:
    """The run's pages, u8 [h, w, 3] (gray, the three channels equal):
    ``batch * pool_batches`` of them.  ``lines``, if given, receives each page's list of line
    boxes (x0, y0, x1, y1)."""
    bank = bank or Bank()
    rng = np.random.default_rng(seed)
    p = mix["pages"]
    n = mix["batch"] * mix["pool_batches"]
    sizes = page_sizes(mix, n, rng)
    pages = []
    boxes: list = [] if lines is None else lines
    if p["layout"] == "lines":
        lo, hi = p["lines"]
        counts = np.resize(np.arange(lo, hi + 1), n)[rng.permutation(n)]
        for (h, w), k in zip(sizes, counts):
            boxes.append([])
            pages.append(_page_lines(rng, bank, h, w, int(k), p, boxes[-1]))
    elif p["layout"] == "rows":
        for h, w in sizes:
            boxes.append([])
            pages.append(_page_rows(rng, bank, h, w, p, boxes[-1]))
    else:
        raise ValueError(f"unknown page layout {p['layout']!r}")
    return [np.repeat(np.clip(np.rint(pg), 0, 255).astype(np.uint8)[..., None], 3, axis=2)
            for pg in pages]

