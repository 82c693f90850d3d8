"""``retto_tpu_torch.weights.hub`` and ``retto-torch ocr --hf-hub`` against
the JAX package's, with no network.

* ``hf_hub_download`` is replaced, for both packages, by a function that
  returns the full-size Paddle-export replicas (``weights/replica.py``) and
  the 6,625-class key file written to a temporary directory under the
  artifact names: ``load_ppocr_onnx_engine()`` of each package, in a
  session with the det settings of tools/make_torch_smoke_fixture.py, reads
  fixture page 0 cut to 320 x 480 alike (texts and cls labels equal,
  boxes within 0.5 px; float32 sums in other orders).
* Both CLIs with ``--hf-hub`` in subprocesses where ``huggingface_hub``
  cannot be imported: exit 1 with the same ``ModelNotFoundError`` line."""

from __future__ import annotations

import os
import subprocess
import sys
from pathlib import Path

import huggingface_hub
import numpy as np
import pytest
from PIL import Image

from retto_tpu.config import SessionConfig as JConfig
from retto_tpu.pipeline.session import RettoSession as JSession
from retto_tpu.weights import hub as jhub
from retto_tpu_torch import ModelNotFoundError, RettoSession, SessionConfig
from retto_tpu_torch.weights import hub, replica

ROOT = Path(__file__).resolve().parent.parent


@pytest.fixture
def replica_hub(tmp_path, monkeypatch):
    """``hf_hub_download`` -> the replica files; the calls it saw."""
    files = {"det": replica.build_det_replica(), "cls": replica.build_cls_replica(),
             "rec": replica.build_rec_replica()}
    for key, name in hub.PPOCR_V4_FILES.items():
        dest = tmp_path / Path(name).name
        if key == "keys":
            dest.write_text((ROOT / "trained_weights" / "charset_big.txt").read_text(
                encoding="utf-8"), encoding="utf-8")
        else:
            dest.write_bytes(files[key])
    calls = []

    def download(repo, filename):
        calls.append((repo, filename))
        return str(tmp_path / Path(filename).name)

    monkeypatch.setattr(huggingface_hub, "hf_hub_download", download)
    monkeypatch.setattr(huggingface_hub.constants, "HF_HUB_OFFLINE", True)
    return calls


def test_artifact_set_is_the_jax_packages():
    assert hub.PPOCR_V4_FILES == jhub.PPOCR_V4_FILES
    assert hub.PPOCR_V4_REPO == jhub.PPOCR_V4_REPO
    assert hub.__all__ == jhub.__all__


def test_ppocr_engine_reads_a_page_like_jax(replica_hub):
    page = np.load(ROOT / "retto_tpu_torch" / "testdata" / "smoke_pages.npz")["pages"][0]
    img = np.repeat(page[360:680, 0:480, None], 3, axis=2)

    def config(cls):
        cfg = cls()
        cfg.engine.transfer_format = "yuv420"
        cfg.det.box_thresh = 0.2
        cfg.det.use_dilation = True
        return cfg

    engine, chars = hub.load_ppocr_onnx_engine(device="cpu")
    assert [f for _, f in replica_hub] == list(hub.PPOCR_V4_FILES.values())
    assert {r for r, _ in replica_hub} == {hub.PPOCR_V4_REPO}
    jengine, jchars = jhub.load_ppocr_onnx_engine()
    assert len(chars) == len(jchars) == 6625
    with RettoSession(config(SessionConfig), engine=engine, charset=chars,
                      device="cpu") as session:
        got = session.run(img)
    ref = JSession(config(JConfig), engine=jengine, charset=jchars).run(img)
    assert len(got.rec_result) == len(ref.rec_result) > 0
    assert [t.text for t in got.rec_result] == [t.text for t in ref.rec_result]
    assert ([c.label for c in got.cls_result] == [c.label for c in ref.cls_result])
    for a, b in zip(got.det_result, ref.det_result):
        np.testing.assert_allclose(np.asarray(a.box.pts, float), np.asarray(b.box.pts, float),
                                   atol=0.5)


def test_missing_package_raises_model_not_found(monkeypatch):
    monkeypatch.setitem(sys.modules, "huggingface_hub", None)
    with pytest.raises(ModelNotFoundError, match="huggingface_hub is not installed"):
        hub.fetch_ppocr_v4()


_CLI = ("import sys; sys.modules['huggingface_hub'] = None; {setup}"
        "sys.path.insert(0, {root!r}); from {pkg}.cli import main; sys.exit(main({args!r}))")


def test_cli_hf_hub_without_the_package_exits_1_like_jax(tmp_path):
    Image.fromarray(np.zeros((64, 64, 3), np.uint8)).save(tmp_path / "a.png")
    runs = {}
    for pkg, setup, extra in (
            ("retto_tpu", "import jax; jax.config.update('jax_platforms', 'cpu'); ", []),
            ("retto_tpu_torch", "", ["--device", "cpu"])):
        code = _CLI.format(setup=setup, root=str(ROOT), pkg=pkg,
                           args=["ocr", str(tmp_path), "--hf-hub", *extra])
        runs[pkg] = subprocess.run([sys.executable, "-c", code], capture_output=True,
                                   text=True, timeout=300,
                                   env=dict(os.environ, HF_HUB_OFFLINE="1"))
    errors = {}
    for pkg, r in runs.items():
        assert r.returncode == 1, (pkg, r.stderr[-2000:])
        assert "Traceback" not in r.stderr, r.stderr[-2000:]
        errors[pkg] = [line for line in r.stderr.splitlines() if line.startswith("error:")]
    want = ("error: huggingface_hub is not installed; cannot fetch "
            f"{hub.PPOCR_V4_REPO}/{hub.PPOCR_V4_FILES['det']}")
    assert errors["retto_tpu_torch"] == errors["retto_tpu"] == [want]
