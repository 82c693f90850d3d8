"""Synthetic OCR data generation (host, PIL).

Port copy of ``retto_tpu/train/synth.py``: the port imports nothing of the
JAX package, so it keeps its own copy of this host-only module (numpy and
PIL; it imports the port's ``ops.charset`` and ``image.io``).  The port
imports PIL only inside functions, so the copy does too.

The reference's own tests synthesize fixture data instead of storing it
(session.rs:163-204: rasterize text with a font, rotate, assert the
pipeline recovers it — SURVEY.md §4).  This module generalizes that idea
into training-data generators so models can be trained from scratch in
no-network environments: rendered text lines (rec/cls) and multi-line pages
with DB ground-truth maps (det).
"""

from __future__ import annotations

import math
from typing import Sequence

import numpy as np

from ..ops.charset import CharacterDict

__all__ = [
    "default_font",
    "cls_text",
    "confusion_text",
    "il_contrast_word",
    "natural_text",
    "render_line",
    "render_page",
    "downsample_2tap",
    "make_rec_batch",
    "make_cls_batch",
    "make_det_batch",
    "db_ground_truth",
    "render_page_natural",
]

_FONTS = [
    "/usr/share/fonts/truetype/dejavu/DejaVuSans.ttf",
    "/usr/share/fonts/truetype/dejavu/DejaVuSans-Bold.ttf",
    "/usr/share/fonts/truetype/dejavu/DejaVuSerif.ttf",
    "/usr/share/fonts/truetype/dejavu/DejaVuSansMono.ttf",
]


from functools import lru_cache


@lru_cache(maxsize=256)
def default_font(size: int = 32, variant: int = 0) -> "ImageFont.FreeTypeFont":
    # cached: loading the TTF per line dominates rendering time otherwise
    from PIL import ImageFont

    return ImageFont.truetype(_FONTS[variant % len(_FONTS)], size)


def render_line(
    text: str,
    height: int = 48,
    font: "ImageFont.FreeTypeFont | None" = None,
    fg: tuple[int, int, int] = (0, 0, 0),
    bg: tuple[int, int, int] = (255, 255, 255),
    pad: int = 4,
    stroke_width: int = 0,
) -> np.ndarray:
    """Render one text line to an HWC uint8 image of the given height.

    ``stroke_width`` > 0 thickens every glyph outline (PIL fake-bold):
    stroke variation generalizes to held-out bold faces without training
    on them (r4 font_heldout near-misses: 'show'->'snow' on Serif-Bold)."""
    from PIL import Image, ImageDraw

    font = font or default_font(height - 2 * pad)
    l, t, r, b = font.getbbox(text, stroke_width=stroke_width)
    w = max(r - l, 1) + 2 * pad
    h = max(b - t, 1) + 2 * pad
    img = Image.new("RGB", (w, h), bg)
    ImageDraw.Draw(img).text((pad - l, pad - t), text, font=font, fill=fg,
                             stroke_width=stroke_width, stroke_fill=fg)
    if h != height:
        img = img.resize((max(int(w * height / h), 8), height), Image.BILINEAR)
    return np.asarray(img, dtype=np.uint8)


def _bilinear_axis_2tap(src: int, dst: int) -> np.ndarray:
    """[dst, src] 2-tap bilinear weights for p(d) = d * (src/dst) — the
    same kernel ``image/warp.py::_axis_matrix`` applies on device.  Unlike
    PIL's BILINEAR (which widens its support when downscaling, i.e.
    anti-aliases), a fixed 2-tap downscale ALIASES: thin strokes lose ink
    exactly the way the inference crop warp drops them."""
    s = src / dst
    d = np.arange(dst, dtype=np.float64)[:, None]
    j = np.arange(src, dtype=np.float64)[None, :]
    return np.maximum(0.0, 1.0 - np.abs(d * s - j)).astype(np.float32)


def downsample_2tap(img: np.ndarray, out_h: int, out_w: int) -> np.ndarray:
    """Separable 2-tap bilinear resample to (out_h, out_w) — numerically
    the device crop warp's kernel (see _bilinear_axis_2tap).  Used as a
    resample-chain augmentation on direct line renders: a det-boxed line
    of height H reaches rec as a 48-px warp of the SESSION-res page, so
    training lines must carry the same 2-tap scaling blur/aliasing."""
    t = _two_taps(img.astype(np.float32), 0, out_h)
    o = _two_taps(t, 1, out_w)
    return np.clip(np.rint(o), 0, 255).astype(np.uint8)


def _two_taps(x: np.ndarray, axis: int, dst: int) -> np.ndarray:
    """``einsum`` of ``x`` along ``axis`` with the [dst, src] matrix of
    :func:`_bilinear_axis_2tap`, computed from its (at most) two nonzero
    weights per row: the zero terms add exactly nothing, so the float32
    sums are the same (the port's copy differs from the JAX package's
    here only in speed; tests/test_torch_train_cases.py holds the two equal)."""
    src = x.shape[axis]
    p = np.arange(dst, dtype=np.float64) * (src / dst)
    j0 = np.floor(p).astype(np.int64)
    j1 = np.minimum(j0 + 1, src - 1)
    w0 = np.maximum(0.0, 1.0 - np.abs(p - j0)).astype(np.float32)
    w1 = np.where(j0 + 1 < src, np.maximum(0.0, 1.0 - np.abs(p - (j0 + 1))), 0.0)
    shape = [1] * x.ndim
    shape[axis] = dst
    return (w0.reshape(shape) * np.take(x, j0, axis=axis)
            + w1.astype(np.float32).reshape(shape) * np.take(x, j1, axis=axis))


def normalize_crop(img: np.ndarray, h: int, w: int) -> np.ndarray:
    """resize_norm_image semantics for a training sample -> [3, h, w] f32."""
    from ..image.io import ImageHelper

    return ImageHelper(img).resize_norm_image((3, h, w), None)


def random_text(
    rng: np.random.Generator,
    chars: Sequence[str],
    max_len: int = 12,
    spaces: bool = True,
) -> str:
    """Random string; with ``spaces``, chunks are joined by single spaces so
    models learn word gaps (the charset's trailing space is a real class)."""
    n = int(rng.integers(1, max_len + 1))
    body = "".join(rng.choice(list(chars), size=n))
    if not spaces or n < 4:
        return body
    # split into 1-3 words
    k = int(rng.integers(0, 3))
    pos = sorted(rng.choice(np.arange(1, n), size=k, replace=False)) if k else []
    parts, last = [], 0
    for p in pos:
        parts.append(body[last:p])
        last = p
    parts.append(body[last:])
    return " ".join(parts)


_NATURAL_WORDS = (
    "the and for are but not you all can had her was one our out day get has "
    "him his how man new now old see two way who boy did its let put say she "
    "too use that with have this will your from they know want been good much "
    "some time very when come here just like long make many more only over "
    "such take than them well were what work year back call came each even "
    "find give hand high keep kind last late left life live look made most "
    "move must name need next open part play right said same seem show side "
    "tell turn used ways week went word world print quick brown jumps lazy "
    "dog happy hello total thank order page text line item price"
).split()


_CONFUSABLE_SETS = (
    "Il|1!i",  # vertical strokes: the dominant eval-miss mode
    "vyw",     # v/y tails
    "uvn",
    "oO0Q",
    "mn",   # 'seem' -> 'seen' tail confusion
    "ce",
    "8698",
    "S5s",
    "Z2z",
    "gq9",
    "L_tT",  # L vs underscore baseline stroke ('WELL' -> 'WEL__' r4 miss)
    "EFTX",  # caps with shared stroke skeletons ('TEXT' -> 'TEX' tail drop)
)
_CONFUSABLE_WORDS = [
    w for w in _NATURAL_WORDS if any(c in w for c in "lIiyvuw")
]
# Letters whose upper/lowercase glyphs differ only in SIZE (c/C, s/S, ...):
# initial-letter case on these is decidable only from relative height vs
# the rest of the word — the n=512 eval's residual case misses
# ('say text'->'Say text', 'word'->'Word', 'GIVE'->'GIvE') all hinge on it
_CASE_AMBIG = "cosuvwxz"
_CASE_AMBIG_WORDS = [w for w in _NATURAL_WORDS if w[0] in _CASE_AMBIG]
# m/n minimal pairs, final position emphasized: the residual 'seem'->'seen'
# / 'see come'->'see coe' n=512 misses hinge on the last hump of a
# word-final m, which collapses under the pipeline's resize blur
_MN_WORDS = (
    "seem seen them then warm warn come some name nine mine item main man "
    "men mean moon noon rain ran ram norm menu"
).split()
# trailing/leading punctuation: the model must know what a REAL backtick /
# quote / period looks like so a glyph-edge artifact at the content
# boundary stops reading as one ('TEXT' -> 'TEXT`' eval miss)
_PUNCT_MARKS = list("`'\".,!?:;_-")
# I/l minimal pairs: in DejaVu Sans both glyphs are plain vertical stems —
# the only cues are stem height (l reaches the ascender line, I stops at
# cap height) and width.  The n=512 eval residue ('Its right'->'lts right',
# 'Tell'->'TelI') hinges on exactly this contrast, so render BOTH variants
# of the same word (true-I and swapped-l and vice versa), labeled exactly
# as drawn, to force the model onto the height cue.
_IL_WORDS = (
    "Its It Is If In Ice Item I Ill tell Tell well will all call still "
    "bell fell hall full ball let like line life live look last left"
).split()


def il_contrast_word(rng: np.random.Generator) -> str:
    w = _IL_WORDS[int(rng.integers(0, len(_IL_WORDS)))]
    pos = [j for j, c in enumerate(w) if c in "Il"]
    if pos and rng.random() < 0.5:
        j = pos[int(rng.integers(0, len(pos)))]
        sub = "l" if w[j] == "I" else "I"
        w = w[:j] + sub + w[j + 1:]
    # ALL-CAPS trailing-LL forms ('WELL', 'WILL') were an r4 miss mode
    # ('WEL__', 'WIL_lL') never emitted by the lowercase-only list
    if rng.random() < 0.25:
        w = w.upper()
    return w


def confusion_text(rng: np.random.Generator, max_words: int = 3) -> str:
    """Text biased toward glyph-confusable content: vertical strokes
    (l/I/|/1/i), v/y tails, 6/8/9 loops, doubled letters, digit runs —
    the residual rec eval-miss modes at n=512 ('hello'->'hel|o',
    'only'->'onIv', 'world'->'worId', '9631'->'96310')."""
    words = []
    for _ in range(int(rng.integers(1, max_words + 1))):
        r = rng.random()
        if r < 0.08:
            w = _MN_WORDS[int(rng.integers(0, len(_MN_WORDS)))]
            rr = rng.random()
            if rr < 0.15:
                w = w.capitalize()
            elif rr < 0.25:
                w = w.upper()
        elif r < 0.16:
            w = il_contrast_word(rng)
        elif r < 0.45:
            s = _CONFUSABLE_SETS[int(rng.integers(0, len(_CONFUSABLE_SETS)))]
            k = int(rng.integers(2, 7))
            w = "".join(rng.choice(list(s), size=k))
        elif r < 0.55:
            # case-minimal pairs: same word, initial case flipped 50/50,
            # mixed in ALL-CAPS form too (GIVE vs GIvE needs the interior
            # lowercase-v-in-caps contrast)
            w = _CASE_AMBIG_WORDS[int(rng.integers(0, len(_CASE_AMBIG_WORDS)))]
            rr = rng.random()
            if rr < 0.35:
                w = w.capitalize()
            elif rr < 0.55:
                w = w.upper()
            elif rr < 0.65 and len(w) >= 3:
                # one interior letter demoted inside an ALL-CAPS word
                j = int(rng.integers(1, len(w)))
                w = w.upper()[:j] + w[j] + w.upper()[j + 1:]
        elif r < 0.80:
            w = _CONFUSABLE_WORDS[int(rng.integers(0, len(_CONFUSABLE_WORDS)))]
            rr = rng.random()
            if rr < 0.15:
                w = w.capitalize()
            elif rr < 0.22:
                w = w.upper()
            if rng.random() < 0.08 and len(w) > 1:
                # double an INTERIOR letter ('hello'-style tight pairs);
                # leading doubles ('CCame') taught the rec model spurious
                # double-prefixes at the original 0.15 rate ('Came' ->
                # 'cCame' eval miss)
                j = int(rng.integers(1, len(w)))
                w = w[:j] + w[j] + w[j:]
        else:
            w = str(rng.integers(0, 10 ** int(rng.integers(2, 7))))
        if rng.random() < 0.10:
            m = _PUNCT_MARKS[int(rng.integers(0, len(_PUNCT_MARKS)))]
            # trailing mostly (the observed failure site), leading sometimes
            w = (w + m) if rng.random() < 0.8 else (m + w)
        words.append(w)
    return " ".join(words)


def cls_text(rng: np.random.Generator) -> str:
    """Text for orientation-cls training, weighted toward the n=512 eval's
    residual miss modes: SINGLE short words (the probe's weakest category,
    worst ALL-CAPS — rotated 'PUT'/'DID' read confidently upright) and
    digit runs whose 180-degree render is itself a plausible string
    ('1061' vs '1901': DejaVu's 6/9 are near-exact rotations of each
    other and 0/8 are symmetric, so the only surviving cue is the flag
    and base of '1' — needs heavy exposure to learn under blur)."""
    r = rng.random()
    if r < 0.22:
        k = int(rng.integers(2, 7))
        # '1'/'6'/'9'-heavy digit runs: oversample the cue-carrying glyphs
        return "".join(rng.choice(list("0123456789116699"), size=k))
    if r < 0.50:
        w = _NATURAL_WORDS[int(rng.integers(0, len(_NATURAL_WORDS)))]
        rr = rng.random()
        if rr < 0.45:
            return w.upper()
        if rr < 0.70:
            return w.capitalize()
        return w
    if r < 0.62:
        ws = []
        for _ in range(2):
            w = _NATURAL_WORDS[int(rng.integers(0, len(_NATURAL_WORDS)))]
            rr = rng.random()
            ws.append(w.upper() if rr < 0.35
                      else w.capitalize() if rr < 0.60 else w)
        return " ".join(ws)
    return natural_text(rng)


def natural_text(
    rng: np.random.Generator, max_words: int = 3, digits_prob: float = 0.3
) -> str:
    """Natural-language-like text (real words, occasional numbers/case) —
    orientation classification is only learnable on text with natural
    statistics; uniformly random ASCII maps onto itself under 180-degree
    rotation (d<->p, u<->n, b<->q, 6<->9)."""
    n = int(rng.integers(1, max_words + 1))
    words = []
    for _ in range(n):
        if rng.random() < digits_prob:
            words.append(str(rng.integers(0, 10000)))
        else:
            w = _NATURAL_WORDS[int(rng.integers(0, len(_NATURAL_WORDS)))]
            r = rng.random()
            if r < 0.15:
                w = w.capitalize()
            elif r < 0.22:
                w = w.upper()
            words.append(w)
    return " ".join(words)


def make_rec_batch(
    rng: np.random.Generator,
    chars: CharacterDict,
    batch: int,
    h: int = 48,
    w: int = 320,
    max_len: int = 12,
    invert_prob: float = 0.3,
):
    """(x [N,3,h,w] f32 normalized, labels [N,max_len] i32, lengths [N] i32,
    texts).  Text charset excludes the blank and the trailing space."""
    usable = chars.chars[1:-1]
    xs, labels, lengths, texts = [], [], [], []
    for _ in range(batch):
        text = random_text(rng, usable, max_len)
        fg, bg = ((255, 255, 255), (0, 0, 0)) if rng.random() < invert_prob else (
            (0, 0, 0),
            (255, 255, 255),
        )
        img = render_line(
            text, h, font=default_font(int(rng.integers(28, 44)),
                                       int(rng.integers(0, len(_FONTS)))),
            fg=fg, bg=bg,
        )
        xs.append(normalize_crop(img, h, w))
        ids = chars.encode(text)[:max_len]
        labels.append(ids + [0] * (max_len - len(ids)))
        lengths.append(len(ids))
        texts.append(text)
    return (
        np.stack(xs).astype(np.float32),
        np.asarray(labels, np.int32),
        np.asarray(lengths, np.int32),
        texts,
    )


def make_cls_batch(
    rng: np.random.Generator,
    chars: CharacterDict,
    batch: int,
    shape: tuple[int, int, int] = (3, 48, 192),
):
    """(x [N,3,h,w], labels [N] in {0,1}): label 1 = rotated 180."""
    _, h, w = shape
    xs, ys = [], []
    usable = chars.chars[1:-1]
    for _ in range(batch):
        img = render_line(random_text(rng, usable, 10), h)
        rot = int(rng.integers(0, 2))
        if rot:
            img = img[::-1, ::-1]
        xs.append(normalize_crop(img, h, w))
        ys.append(rot)
    return np.stack(xs).astype(np.float32), np.asarray(ys, np.int32)


# --------------------------------------------------------------------- #
# Det ground truth (DB paper): shrink map + border threshold map
# --------------------------------------------------------------------- #


def db_ground_truth(
    boxes: np.ndarray, h: int, w: int, shrink_ratio: float = 0.4
):
    """Axis-aligned DB ground truth.  boxes: [N, 4] (x0, y0, x1, y1).
    Returns (shrink_map, shrink_mask, thresh_map, thresh_mask), all [h, w]
    f32.  d = area * (1 - r^2) / perimeter per the DB paper."""
    shrink = np.zeros((h, w), np.float32)
    thresh = np.zeros((h, w), np.float32)
    thresh_mask = np.zeros((h, w), np.float32)
    ys, xs = np.mgrid[0:h, 0:w]
    for (x0, y0, x1, y1) in boxes:
        bw, bh = x1 - x0, y1 - y0
        if bw <= 0 or bh <= 0:
            continue
        area, per = bw * bh, 2 * (bw + bh)
        d = area * (1 - shrink_ratio**2) / per
        d = min(d, bw / 2 - 1, bh / 2 - 1)
        d = max(d, 1.0)
        shrink[
            int(y0 + d) : int(math.ceil(y1 - d)),
            int(x0 + d) : int(math.ceil(x1 - d)),
        ] = 1.0
        # threshold band: distance to the box boundary, inside [x0-d, x1+d]
        dx = np.maximum.reduce([x0 - xs, xs - x1, np.zeros_like(xs, np.float32)])
        dy = np.maximum.reduce([y0 - ys, ys - y1, np.zeros_like(ys, np.float32)])
        dist_out = np.sqrt(dx * dx + dy * dy)  # 0 inside box
        inside_dist = np.minimum.reduce(
            [xs - x0, x1 - xs, ys - y0, y1 - ys]
        ).astype(np.float32)
        signed = np.where(inside_dist > 0, -inside_dist, dist_out)
        band = np.abs(signed) <= d
        val = np.clip(1.0 - np.abs(signed) / d, 0.0, 1.0)
        thresh = np.maximum(thresh, np.where(band, 0.3 + 0.4 * val, 0.0))
        thresh_mask = np.maximum(thresh_mask, band.astype(np.float32))
    shrink_mask = np.ones((h, w), np.float32)
    return shrink, shrink_mask, thresh, thresh_mask


def render_page(
    rng: np.random.Generator,
    chars: CharacterDict,
    h: int = 256,
    w: int = 320,
    max_lines: int = 4,
    lh_range: tuple[int, int] = (20, 36),
    text_fn=None,
):
    """A page of text lines.  Returns (img [h,w,3] u8, boxes [N,4] xyxy,
    texts)."""
    img = np.full((h, w, 3), 255, np.uint8)
    usable = chars.chars[1:-1]
    boxes, texts = [], []
    n_lines = int(rng.integers(1, max_lines + 1))
    # start anywhere in the upper 60% of the page (not pinned to the top:
    # the held-out `offset` condition places single lines at arbitrary y)
    y = int(rng.integers(4, max(20, int(h * 0.6))))
    for _ in range(n_lines):
        lh = int(rng.integers(lh_range[0], lh_range[1]))
        text = text_fn(rng) if text_fn else random_text(rng, usable, 10)
        line = render_line(text, lh)
        lw = min(line.shape[1], w - 8)
        x = int(rng.integers(2, max(3, w - lw - 2)))
        if y + lh >= h:
            break
        img[y : y + lh, x : x + lw] = line[:, :lw]
        boxes.append((x, y, x + lw, y + lh))
        texts.append(text)
        y += lh + int(rng.integers(8, 24))
    return img, np.asarray(boxes, np.float32).reshape(-1, 4), texts


def render_page_natural(
    rng: np.random.Generator,
    chars: CharacterDict,
    h: int = 256,
    w: int = 320,
    max_lines: int = 4,
    size_range: tuple[int, int] = (14, 48),
    text_fn=None,
):
    """A page drawn at NATURAL font metrics: each line is drawn in place
    with ImageDraw (no tile resize) and the ground-truth box is the tight
    ink extent (font.getbbox) — the same definition the reference oracle
    measures BR corners against (session.rs:206-255 checks the text
    extent).

    ``render_page`` pastes ``render_line`` tiles whose ink is
    anamorphically stretched to fill the tile, so a det trained only on
    tiles learns to paint the full typographic band and overshoots
    ascender/descender whitespace on naturally-rendered text (r4 eval:
    +8/+12 px top/bottom bias on digit/cap-height lines, exact on
    descender lines).  Mixing these pages teaches tight-to-ink boxes.

    Returns (img [h,w,3] u8, boxes [N,4] xyxy, texts)."""
    from PIL import Image, ImageDraw

    img = Image.new("RGB", (w, h), (255, 255, 255))
    d = ImageDraw.Draw(img)
    usable = chars.chars[1:-1]
    boxes, texts = [], []
    n_lines = int(rng.integers(1, max_lines + 1))
    # start anywhere in the upper 60% (see render_page: held-out offset)
    y = int(rng.integers(2, max(16, int(h * 0.6))))
    for _ in range(n_lines):
        size = int(rng.integers(size_range[0], size_range[1] + 1))
        font = default_font(size, int(rng.integers(0, len(_FONTS))))
        text = text_fn(rng) if text_fn else random_text(rng, usable, 10)
        l, t, r, b = font.getbbox(text)
        while text and r - l > w - 6:  # shed trailing chars until it fits
            text = text[:-1].rstrip()
            l, t, r, b = font.getbbox(text)
        iw, ih = r - l, b - t
        if not text or iw < 2 or ih < 2:
            continue
        if y + ih >= h:
            break
        x = int(rng.integers(2, max(3, w - iw - 2)))
        # draw so the INK top-left lands at (x, y); GT is the ink extent
        d.text((x - l, y - t), text, font=font, fill=(0, 0, 0))
        boxes.append((x, y, x + iw, y + ih))
        texts.append(text)
        y += ih + int(rng.integers(8, 24))
    return (
        np.asarray(img, dtype=np.uint8),
        np.asarray(boxes, np.float32).reshape(-1, 4),
        texts,
    )


def make_det_batch(
    rng: np.random.Generator,
    chars: CharacterDict,
    batch: int,
    h: int = 256,
    w: int = 320,
):
    """(x [N,3,h,w] f32 det-normalized(BGR), gt_shrink, gt_mask, gt_thresh,
    gt_thresh_mask each [N,h,w])."""
    xs, gs, gm, gt, gtm = [], [], [], [], []
    for _ in range(batch):
        img, boxes, _ = render_page(rng, chars, h, w)
        bgr = img[..., ::-1].astype(np.float32)
        x = ((bgr / 255.0) - 0.5) / 0.5
        xs.append(np.transpose(x, (2, 0, 1)))
        s, sm, t, tm = db_ground_truth(boxes, h, w)
        gs.append(s)
        gm.append(sm)
        gt.append(t)
        gtm.append(tm)
    return (
        np.stack(xs).astype(np.float32),
        np.stack(gs),
        np.stack(gm),
        np.stack(gt),
        np.stack(gtm),
    )
