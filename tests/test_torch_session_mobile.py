"""The port's staged ``RettoSession.run`` at full width (the shipped mobile
checkpoints, bf16) against the JAX session on fixture pages 0 and 1, in
COMPAT and PERFORMANCE mode.

Tolerances: box counts and cls labels equal; boxes within 2 px and det
scores within 1e-5 (measured 0.00 px and 0.0 on all 35 lines of the 8
fixture pages, both modes: the det matches Flax bit for bit on the CPU,
tests/test_torch_det_parity.py); texts equal (page 0's ``'ep1lyr:#s('``
read ``'eplyr:#s('`` until the rec's LCNet took XLA:CPU's order, ROADMAP
Queue 3 item 3, so ``NOISE_LINES`` is empty); rec scores within 0.03."""

from __future__ import annotations

from pathlib import Path

import numpy as np
import pytest

from retto_tpu.config import PipelineMode as JMode, SessionConfig as JConfig
from retto_tpu.ops.charset import CharacterDict as JChars
from retto_tpu.pipeline.session import RettoSession as JSession
from retto_tpu_torch import PipelineMode, RettoSession, SessionConfig
from retto_tpu_torch.ops.charset import CharacterDict

ROOT = Path(__file__).resolve().parent.parent
PAGES = (0, 1)
# (page, JAX text) of the lines the CPU noise moves, with the port's reading
NOISE_LINES: dict[tuple[int, str], str] = {}


@pytest.fixture(scope="module")
def fixture_pages():
    fx = np.load(ROOT / "retto_tpu_torch" / "testdata" / "smoke_pages.npz")
    return [np.repeat(fx["pages"][p][..., None], 3, axis=2) for p in PAGES]


@pytest.mark.parametrize("mode", ["compat", "performance"])
def test_mobile_staged_session_matches_jax(fixture_pages, mode):
    chars = (ROOT / "trained_weights" / "charset.txt").read_text().splitlines()
    weights = {k: str(ROOT / "trained_weights" / f"{k}.npz") for k in ("det", "cls", "rec")}
    session = RettoSession(SessionConfig(mode=PipelineMode(mode)), charset=CharacterDict(chars),
                           weights=weights, device="cpu")
    jsession = JSession(JConfig(mode=JMode(mode)), charset=JChars(chars), weights=weights)
    moved = []
    for p, page in zip(PAGES, fixture_pages):
        got, ref = session.run(page), jsession.run(page)
        assert len(got.det_result) == len(ref.det_result) > 0
        assert [c.label for c in got.cls_result] == [c.label for c in ref.cls_result]
        for g, r in zip(got.det_result, ref.det_result):
            assert np.abs(np.asarray(g.box.pts) - np.asarray(r.box.pts)).max() <= 2.0
            assert abs(g.score - r.score) <= 1e-5
        for g, r in zip(got.rec_result, ref.rec_result):
            if g.text != r.text:
                moved.append(((p, r.text), g.text))
            else:
                assert abs(g.score - r.score) <= 0.03
    assert dict(moved) == {k: v for k, v in NOISE_LINES.items() if k[0] in PAGES}
