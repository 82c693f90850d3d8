"""Render the glyph bank that the page generator composes pages from.

The machines that run the benchmark have no fonts, so every glyph of the
charset (and the space) is rendered once here with DejaVu Sans at 64 px
and kept as ink coverage (0 = paper, 255 = ink) in ``bank.npz`` beside
this file:

* ``tiles``: u8 [n, band, width], glyph k drawn at x = ``PAD`` on the
  font's ascent + descent band;
* ``advance``: float32 [n], the pen advance of each glyph;
* ``chars``: the glyphs, in the order of the tiles.

    python3 benchmark/traffic/make_bank.py [--charset trained_weights/charset.txt]
"""

from __future__ import annotations

import argparse
import math
from pathlib import Path

import numpy as np

FONT = "/usr/share/fonts/truetype/dejavu/DejaVuSans.ttf"
SIZE = 64
PAD = 8
HERE = Path(__file__).resolve().parent


def render(chars: list[str]) -> dict[str, np.ndarray]:
    from PIL import Image, ImageDraw, ImageFont

    font = ImageFont.truetype(FONT, SIZE)
    ascent, descent = font.getmetrics()
    band = ascent + descent
    adv = [font.getlength(c) for c in chars]
    width = int(math.ceil(max(adv))) + 2 * PAD
    tiles = np.zeros((len(chars), band, width), np.uint8)
    for k, c in enumerate(chars):
        img = Image.new("L", (width, band), 0)
        ImageDraw.Draw(img).text((PAD, 0), c, font=font, fill=255)
        tiles[k] = np.asarray(img)
    return {"tiles": tiles, "advance": np.asarray(adv, np.float32),
            "chars": np.asarray(chars)}


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--charset", default=str(HERE.parents[1] / "trained_weights" / "charset.txt"))
    ap.add_argument("--out", default=str(HERE / "bank.npz"))
    args = ap.parse_args()
    chars = Path(args.charset).read_text(encoding="utf-8").splitlines() + [" "]
    np.savez_compressed(args.out, **render(chars))


if __name__ == "__main__":
    main()
