"""The port's ONNX path (``retto_tpu_torch.pipeline.onnx_engine``, the
session and the fused ``DevicePipeline`` over translated graphs) against
the JAX package's on the CPU, on the same ONNX bytes.

* The three full-size Paddle-export replicas (``weights/replica.py``) at
  small inputs: outputs within 2e-5 of max |JAX| (float32 sums in another
  order; measured <= 3e-6).
* The hermetic det / cls / rec graphs of tests/test_device_pipeline.py
  through both packages' fused ``run_many`` and staged ``run``: texts and
  cls labels equal, boxes within 0.5 px (measured 0.00).
* The replica engine on one fixture page cut to 320 x 480, fused and
  staged: texts and labels equal, boxes within 0.5 px.
* The engine contract, ``resolve_model_source``, ``params()`` and
  ``modules()``."""

from __future__ import annotations

from pathlib import Path

import numpy as np
import pytest
import torch

from retto_tpu.config import BucketConfig as JBuckets, PipelineMode as JMode
from retto_tpu.config import SessionConfig as JConfig
from retto_tpu.ops.charset import CharacterDict as JChars
from retto_tpu.pipeline.onnx_engine import OnnxEngine as JEngine
from retto_tpu.pipeline.session import RettoSession as JSession
from retto_tpu.weights import replica as jrep
from retto_tpu.weights.onnx_proto import encode_model, encode_node
from retto_tpu_torch import (
    BucketConfig,
    ModelNotFoundError,
    OnnxEngine,
    PipelineMode,
    RettoEngineError,
    RettoSession,
    SessionConfig,
)
from retto_tpu_torch.ops.charset import CharacterDict
from retto_tpu_torch.pipeline.device_pipeline import DevicePipeline
from retto_tpu_torch.pipeline.onnx_engine import OnnxModule, resolve_model_source
from retto_tpu_torch.weights import replica

ROOT = Path(__file__).resolve().parent.parent


def _host(x) -> np.ndarray:
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


@pytest.mark.parametrize("kind,shape", [("det", (1, 3, 64, 96)), ("cls", (2, 3, 48, 192)),
                                        ("rec", (2, 3, 48, 160))])
def test_replica_graphs_match_jax(kind, shape):
    build = getattr(replica, f"build_{kind}_replica")
    data = build()
    assert data == getattr(jrep, f"build_{kind}_replica")()
    x = np.random.default_rng(0).uniform(-1, 1, shape).astype(np.float32)
    got = _host(getattr(OnnxEngine(**{kind: data}, device="cpu"), kind)(x))
    ref = np.asarray(getattr(JEngine(**{kind: data}), kind)(x))
    assert got.shape == ref.shape
    assert np.abs(got - ref).max() <= 2e-5 * np.abs(ref).max()


def _hermetic_graphs() -> dict[str, bytes]:
    """tests/test_device_pipeline.py::test_device_pipeline_from_onnx_engine's
    graphs: a dark-region det, a cls and a 6-class rec."""
    rng = np.random.default_rng(7)
    det = encode_model(
        [encode_node("Conv", ["x", "w"], ["c"], pads=[1, 1, 1, 1]),
         encode_node("Sigmoid", ["c"], ["y"])],
        {"w": np.full((1, 3, 3, 3), -1.0 / 27.0, np.float32)},
        {"x": [1, 3, 64, 64]}, {"y": [1, 1, 64, 64]},
    )
    cls = encode_model(
        [encode_node("Conv", ["x", "wc"], ["c"]),
         encode_node("GlobalAveragePool", ["c"], ["g"]),
         encode_node("Flatten", ["g"], ["f"]),
         encode_node("Softmax", ["f"], ["y"], axis=-1)],
        {"wc": rng.normal(size=(2, 3, 1, 1)).astype(np.float32)},
        {"x": [1, 3, 48, 192]}, {"y": [1, 2]},
    )
    rec = encode_model(
        [encode_node("AveragePool", ["x"], ["p"], kernel_shape=[48, 8], strides=[48, 8]),
         encode_node("Conv", ["p", "wr"], ["c"]),
         encode_node("Squeeze", ["c"], ["s"], axes=[2]),
         encode_node("Transpose", ["s"], ["t"], perm=[0, 2, 1]),
         encode_node("Softmax", ["t"], ["y"], axis=-1)],
        {"wr": rng.normal(size=(6, 3, 1, 1)).astype(np.float32)},
        {"x": [1, 3, 48, 320]}, {"y": [1, 40, 6]},
    )
    return {"det": det, "cls": cls, "rec": rec}


def _small_buckets(cfg, buckets_cls):
    """The JAX test's small buckets.  The hermetic cls pools globally, which
    a 180-degree turn leaves unchanged, so its orientation-symmetrized
    probabilities are 0.5 / 0.5 by construction and a 1-ulp sum picks the
    label: both packages score the crop alone (``symmetrize=False``)."""
    cfg.cls.symmetrize = False
    cfg.det.limit_side_len = 128
    cfg.buckets = buckets_cls(
        det_pad_to=64, det_max_side=256, rec_width_buckets=(320,),
        cls_batch_buckets=(4,), rec_batch_buckets=(4,), det_batch_buckets=(4,),
    )
    return cfg


def _lines(res):
    return [[(np.asarray(b.box.pts, np.float64), t.text, c.label)
             for b, t, c in zip(r.det_result, r.rec_result, r.cls_result)] for r in res]


def _assert_same(got, ref, box_px=0.5):
    assert len(got) == len(ref)
    for g_page, r_page in zip(_lines(got), _lines(ref)):
        assert len(g_page) == len(r_page) > 0
        for (gb, gt, gl), (rb, rt, rl) in zip(g_page, r_page):
            assert gt == rt and gl == rl
            assert np.abs(gb - rb).max() <= box_px


@pytest.fixture(scope="module")
def hermetic():
    graphs = _hermetic_graphs()
    rng = np.random.default_rng(5)
    # dark bars the det graph flags, with noise so the crops differ
    img = np.full((160, 200, 3), 255, np.uint8)
    img[60:90, 40:160] = rng.integers(0, 40, (30, 120, 3))
    img2 = img.copy()
    img2[110:130, 20:180] = rng.integers(20, 70, (20, 160, 3))
    return graphs, [img, img2]


@pytest.mark.parametrize("mode", ["compat", "performance"])
def test_hermetic_fused_and_staged_match_jax(hermetic, mode):
    graphs, imgs = hermetic
    cfg = _small_buckets(SessionConfig(mode=PipelineMode(mode)), BucketConfig)
    jcfg = _small_buckets(JConfig(mode=JMode(mode)), JBuckets)
    with RettoSession(cfg, engine=OnnxEngine(**graphs, device="cpu"),
                      charset=CharacterDict(list("abcd")), device="cpu") as session:
        jsession = JSession(jcfg, engine=JEngine(**graphs), charset=JChars(list("abcd")))
        dp = session.device_pipeline()
        assert isinstance(dp, DevicePipeline) and not dp._det_native
        assert dp._det_stride == 1
        _assert_same(dp.run_many(imgs), jsession.device_pipeline().run_many(imgs))
        _assert_same([session.run(x) for x in imgs], [jsession.run(x) for x in imgs])


def test_replica_engine_on_a_fixture_page_matches_jax():
    """The replica engine (det with its ink scaffold, 6,625-class rec) on
    fixture page 0 cut to 320 x 480, fused and staged, with the det
    settings of tools/make_torch_smoke_fixture.py (box_thresh 0.2,
    dilation)."""
    page = np.load(ROOT / "retto_tpu_torch" / "testdata" / "smoke_pages.npz")["pages"][0]
    img = np.repeat(page[360:680, 0:480, None], 3, axis=2)
    chars = (ROOT / "trained_weights" / "charset_big.txt").read_text(
        encoding="utf-8").splitlines()
    graphs = {k: getattr(replica, f"build_{k}_replica")() for k in ("det", "cls", "rec")}

    def config(cls):
        cfg = cls()
        cfg.engine.transfer_format = "yuv420"
        cfg.det.box_thresh = 0.2
        cfg.det.use_dilation = True
        return cfg

    with RettoSession(config(SessionConfig), engine=OnnxEngine(**graphs, device="cpu"),
                      charset=CharacterDict(chars), device="cpu") as session:
        jsession = JSession(config(JConfig), engine=JEngine(**graphs), charset=JChars(chars))
        got = session.device_pipeline().run_many([img])
        ref = jsession.device_pipeline().run_many([img])
        _assert_same(got, ref)
        _assert_same([session.run(img)], [jsession.run(img)])


def test_engine_contract_and_sources(tmp_path):
    graphs = _hermetic_graphs()
    path = tmp_path / "det.onnx"
    path.write_bytes(graphs["det"])
    engine = OnnxEngine(det=path, cls=graphs["cls"], rec=bytearray(graphs["rec"]),
                        device="cpu")
    x = np.random.default_rng(1).uniform(-1, 1, (2, 3, 48, 320)).astype(np.float32)
    assert tuple(engine.det(x).shape) == (2, 1, 48, 320)
    assert tuple(engine.cls(x).shape) == (2, 2)
    assert tuple(engine.rec(x).shape) == (2, 40, 6)
    mods = engine.modules()
    assert set(mods) == {"det", "cls", "rec"}
    assert all(isinstance(m, OnnxModule) for m in mods.values())
    params = engine.params()
    assert set(params["rec"]) == {"wr"}
    assert all(isinstance(t, torch.Tensor) and t.dtype == torch.float32
               for p in params.values() for t in p.values())
    np.testing.assert_array_equal(params["det"]["w"].numpy(),
                                  np.full((1, 3, 3, 3), -1.0 / 27.0, np.float32))
    assert engine.lock is not None
    assert resolve_model_source(path) == graphs["det"]
    with pytest.raises(ModelNotFoundError):
        resolve_model_source(b"")
    with pytest.raises(ModelNotFoundError):
        resolve_model_source(tmp_path / "missing.onnx")
    with pytest.raises(RettoEngineError, match="no 'cls'"):
        OnnxEngine(det=graphs["det"], device="cpu").cls(x)


def test_hub_source_without_huggingface_hub(monkeypatch):
    """A dict source needs huggingface_hub; without it the port raises
    ModelNotFoundError, as the JAX package does."""
    import builtins

    real = builtins.__import__

    def no_hub(name, *a, **kw):
        if name == "huggingface_hub":
            raise ImportError(name)
        return real(name, *a, **kw)

    monkeypatch.setattr(builtins, "__import__", no_hub)
    with pytest.raises(ModelNotFoundError, match="huggingface_hub"):
        resolve_model_source({"repo": "r", "file": "f.onnx"})


def test_session_over_onnx_engine_shares_the_engine_lock():
    graphs = _hermetic_graphs()
    engine = OnnxEngine(**graphs, device="cpu")
    cfg = _small_buckets(SessionConfig(), BucketConfig)
    with RettoSession(cfg, engine=engine, charset=CharacterDict(list("abcd")),
                      device="cpu") as session:
        assert session.device_pipeline()._lock is engine.lock


def test_the_default_device_is_cuda():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid")
    with pytest.raises(Exception):
        OnnxEngine(det=_hermetic_graphs()["det"])
