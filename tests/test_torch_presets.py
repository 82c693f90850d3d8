"""The server preset (``det_server.npz``, ``rec_server.npz``, ``cls.npz``)
through the port's fused pipeline on the CPU against the JAX pipeline's
lines for fixture page 0 (``testdata/smoke_presets.npz``,
tools/make_torch_smoke_fixture.py --presets), and the big-vocab rec
(``rec_big.npz``, 6,625 classes) on the fixture's 16 crops at 48x320.

Tolerances: the main path's line rule (chip_smoke.py): equal texts with
boxes within 2 px on at least 95% of the lines and no box beyond 4 px
(measured on the CPU: every line of page 0 equal, boxes 0.00 px); the
big-vocab texts equal on at least 95% of the crops (measured 16 of 16)."""

from __future__ import annotations

from pathlib import Path

import numpy as np
import torch

from retto_tpu_torch import RettoSession, SessionConfig
from retto_tpu_torch.models import build_rec
from retto_tpu_torch.models.common import cast_compute
from retto_tpu_torch.ops.charset import CharacterDict
from retto_tpu_torch.ops.ctc import ctc_greedy_decode
from retto_tpu_torch.weights import load_flax_params, load_params_meta

ROOT = Path(__file__).resolve().parent.parent
WD = ROOT / "trained_weights"
FX = ROOT / "retto_tpu_torch" / "testdata"


def test_server_preset_fused_page_matches_jax():
    fx = np.load(FX / "smoke_presets.npz")
    page = np.load(FX / "smoke_pages.npz")["pages"][0]
    chars = CharacterDict((WD / "charset.txt").read_text().splitlines())
    weights = {"det": str(WD / "det_server.npz"), "cls": str(WD / "cls.npz"),
               "rec": str(WD / "rec_server.npz")}
    cfg = SessionConfig()
    cfg.engine.transfer_format = "yuv420"
    with RettoSession(cfg, preset="server", charset=chars, weights=weights,
                      device="cpu") as session:
        res = session.device_pipeline().run_many([np.repeat(page[..., None], 3, axis=2)])[0]
    sel = fx["server_page"] == 0
    ref_boxes, ref_texts = fx["server_boxes"][sel], [str(t) for t in fx["server_texts"][sel]]
    got = [(np.asarray(b.box.pts, np.float32), t.text)
           for b, t in zip(res.det_result, res.rec_result)]
    assert len(got) == len(ref_texts) > 0
    agree, worst = 0, 0.0
    for rb, rt in zip(ref_boxes, ref_texts):
        d, text = min((float(np.abs(b - rb).max()), t) for b, t in got)
        worst = max(worst, d)
        agree += text == rt and d <= 2.0
    assert agree >= 0.95 * len(ref_texts) and worst <= 4.0, (agree, worst)


def test_big_vocab_rec_matches_jax():
    fx = np.load(FX / "smoke_presets.npz")
    big = CharacterDict((WD / "charset_big.txt").read_text(encoding="utf-8").splitlines())
    flat, meta = load_params_meta(WD / "rec_big.npz")
    model = load_flax_params(build_rec(meta["preset"], num_classes=big.num_classes,
                                       **meta["overrides"]), flat)
    model = cast_compute(model, torch.bfloat16).eval()
    crops = torch.from_numpy(fx["big_crops"])
    x = (crops.float() / 255.0 - 0.5) / 0.5
    col = torch.arange(x.shape[2])[None, None, :, None]
    x = torch.where(col < torch.from_numpy(fx["big_widths"])[:, None, None, None], x, 0.0)
    with torch.no_grad():
        idx, keep, _ = ctc_greedy_decode(model(x.permute(0, 3, 1, 2).contiguous()))
    texts = big.decode_indices(idx.numpy(), keep.numpy())
    agree = sum(a == str(b) for a, b in zip(texts, fx["big_texts"]))
    assert agree >= 0.95 * len(texts), agree
