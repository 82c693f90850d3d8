"""Write retto_tpu_torch/testdata/smoke_pages.npz: the pages and the JAX
reference outputs that ``chip_smoke.py`` and tests/test_torch_pipeline.py
hold the port to.

Pages: 8 gray 960x704 pages from ``retto_tpu.train.synth.render_page`` with
``np.random.default_rng(0)`` (the bench.py config-3 recipe, bench.py:127-132).
Reference: the JAX ``DevicePipeline`` on the CPU with the mobile checkpoints
``trained_weights/{det,cls,rec}.npz`` and ``transfer_format="yuv420"``:

* ``jax_*``        the 8 gray pages (they take the ``gray`` plane format);
* ``jax_tinted_*`` page 0 tinted by ``tint`` (numpy, per channel), which
                   takes the ``yuv420`` format;
* ``jax_rotated_*`` page 2 tinted and rotated by ``rotate_deg``
                   (``scipy.ndimage.rotate``, order 1, white fill): rotated
                   quads take the gather warp, upside-down lines the cls flip;
* ``jax_rgb_*``    page 1 through a session with ``transfer_format="rgb"``.

Each reference is flat: ``*_page`` (page index per line), ``*_boxes``
([n, 4, 2] quads in page coordinates) and ``*_texts``.  Ground truth is
``gt_page``/``gt_boxes`` (xyxy)/``gt_texts``.

``retto_tpu_torch/testdata/smoke_staged.npz`` holds the staged references:
the JAX ``RettoSession.run`` (mobile checkpoints, CPU) in each mode, as
``{compat,performance}_{page,boxes,texts,det_scores,rec_scores}``, over
the 8 gray pages (ids 0-7), the tinted page 0 (id 8) and the tinted and
rotated page 2 (id 9).

Run from the repository root (JAX on the CPU, a few minutes; ``--staged``
writes only the staged file):

    JAX_PLATFORMS=cpu python tools/make_torch_smoke_fixture.py [--staged]
"""

from __future__ import annotations

import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

OUT = ROOT / "retto_tpu_torch" / "testdata" / "smoke_pages.npz"
STAGED_OUT = OUT.with_name("smoke_staged.npz")
TINT = np.asarray([1.0, 0.94, 0.86], np.float32)
ROTATE_DEG = 176.0


def tint_page(gray: np.ndarray, tint: np.ndarray = TINT) -> np.ndarray:
    """Gray [H, W] u8 -> RGB [H, W, 3] u8 scaled per channel (chroma != 0)."""
    return np.rint(gray[..., None].astype(np.float32) * tint).astype(np.uint8)


def rotate_page(rgb: np.ndarray, deg: float = ROTATE_DEG) -> np.ndarray:
    from scipy import ndimage

    return ndimage.rotate(rgb, deg, reshape=False, order=1, cval=255)


def _flat(results, pages_idx):
    page, boxes, texts = [], [], []
    for p, r in zip(pages_idx, results):
        for b, t in zip(r.det_result, r.rec_result):
            page.append(p)
            boxes.append(np.asarray(b.box.pts, np.float32))
            texts.append(t.text)
    return (np.asarray(page, np.int32), np.asarray(boxes, np.float32).reshape(-1, 4, 2),
            np.asarray(texts, dtype=str))


def staged_pages(pages: np.ndarray) -> list[np.ndarray]:
    """The 10 staged inputs: gray pages 0-7, tinted page 0, rotated page 2."""
    rgb = [np.repeat(p[..., None], 3, axis=2) for p in pages]
    return rgb + [tint_page(pages[0]), rotate_page(tint_page(pages[2]))]


def write_staged(pages: np.ndarray) -> None:
    from retto_tpu.config import PipelineMode, SessionConfig
    from retto_tpu.ops.charset import CharacterDict
    from retto_tpu.pipeline.session import RettoSession

    wd = ROOT / "trained_weights"
    chars = CharacterDict((wd / "charset.txt").read_text().splitlines())
    weights = {k: str(wd / f"{k}.npz") for k in ("det", "cls", "rec")}
    inputs = staged_pages(pages)
    out = {}
    for mode in ("compat", "performance"):
        session = RettoSession(SessionConfig(mode=PipelineMode(mode)), preset="mobile",
                               charset=chars, weights=weights)
        res = [session.run(x) for x in inputs]
        page, boxes, texts = _flat(res, range(len(inputs)))
        out[f"{mode}_page"], out[f"{mode}_boxes"], out[f"{mode}_texts"] = page, boxes, texts
        out[f"{mode}_det_scores"] = np.asarray(
            [b.score for r in res for b in r.det_result], np.float32)
        out[f"{mode}_rec_scores"] = np.asarray(
            [t.score for r in res for t in r.rec_result], np.float32)
        print(f"staged {mode}: {len(texts)} lines over {len(inputs)} pages")
    np.savez_compressed(STAGED_OUT, **out)
    print(f"wrote {STAGED_OUT.relative_to(ROOT)} ({STAGED_OUT.stat().st_size} bytes)")


def main() -> None:
    if "--staged" in sys.argv[1:]:
        write_staged(np.load(OUT)["pages"])
        return
    from retto_tpu.config import SessionConfig
    from retto_tpu.ops.charset import CharacterDict
    from retto_tpu.pipeline.session import RettoSession
    from retto_tpu.train.synth import render_page

    wd = ROOT / "trained_weights"
    chars = CharacterDict((wd / "charset.txt").read_text().splitlines())
    weights = {k: str(wd / f"{k}.npz") for k in ("det", "cls", "rec")}
    rng = np.random.default_rng(0)
    rendered = [render_page(rng, chars, h=960, w=704, max_lines=6, lh_range=(24, 48))
                for _ in range(8)]
    pages = np.stack([img[..., 0] for img, _, _ in rendered])
    assert all((img == img[..., :1]).all() for img, _, _ in rendered)
    gt_page = np.asarray([p for p, (_, b, _) in enumerate(rendered) for _ in b], np.int32)
    gt_boxes = np.concatenate([b for _, b, _ in rendered]).astype(np.float32)
    gt_texts = np.asarray([t for _, _, ts in rendered for t in ts], dtype=str)

    out = dict(pages=pages, gt_page=gt_page, gt_boxes=gt_boxes, gt_texts=gt_texts,
               tint=TINT, rotate_deg=np.float32(ROTATE_DEG))
    for transfer in ("yuv420", "rgb"):
        cfg = SessionConfig()
        cfg.engine.transfer_format = transfer
        dp = RettoSession(cfg, preset="mobile", charset=chars,
                          weights=weights).device_pipeline()
        if transfer == "yuv420":
            rgb = [np.repeat(p[..., None], 3, axis=2) for p in pages]
            res = dp.run_many(rgb)
            out["jax_page"], out["jax_boxes"], out["jax_texts"] = _flat(res, range(8))
            res = dp.run_many([tint_page(pages[0]), rotate_page(tint_page(pages[2]))])
            (out["jax_tinted_page"], out["jax_tinted_boxes"],
             out["jax_tinted_texts"]) = _flat(res[:1], [0])
            (out["jax_rotated_page"], out["jax_rotated_boxes"],
             out["jax_rotated_texts"]) = _flat(res[1:], [2])
        else:
            res = dp.run_many([np.repeat(pages[1][..., None], 3, axis=2)])
            out["jax_rgb_page"], out["jax_rgb_boxes"], out["jax_rgb_texts"] = _flat(res, [1])
        dp.close()
    OUT.parent.mkdir(parents=True, exist_ok=True)
    np.savez_compressed(OUT, **out)
    hits = sum(t in set(gt_texts) for t in out["jax_texts"])
    print(f"wrote {OUT.relative_to(ROOT)} ({OUT.stat().st_size} bytes): "
          f"{len(gt_texts)} gt lines, {len(out['jax_texts'])} JAX lines, "
          f"{hits} JAX lines equal to a ground-truth line")
    write_staged(pages)


if __name__ == "__main__":
    main()
