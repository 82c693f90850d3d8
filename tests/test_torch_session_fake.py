"""The port's staged session and stages with the port's FakeEngine, against
the JAX session and stages with JAX's FakeEngine on the same inputs.

Every case of tests/test_compat_semantics.py (5) and tests/test_pipeline.py
(14) runs here against the port, with the same assertions.  Each case also
holds the port to the JAX package: equal engine calls and stage outputs for
the stage cases; for the session cases, ``OcrResult.to_dict()`` equal to the
JAX session's on the same input in both modes (exact: the FakeEngine's
outputs are closed-form, and every host step is a copy of the JAX one)."""

from __future__ import annotations

import io

import numpy as np
import pytest
from PIL import Image

from retto_tpu.config import (
    BucketConfig as JBucket,
    ClsConfig as JClsCfg,
    PipelineMode as JMode,
    RecConfig as JRecCfg,
    SessionConfig as JConfig,
)
from retto_tpu.image.io import ImageHelper as JImage
from retto_tpu.ops.charset import CharacterDict as JChars
from retto_tpu.pipeline.engine import FakeEngine as JFake
from retto_tpu.pipeline.session import RettoSession as JSession
from retto_tpu.pipeline.stages import ClsStage as JClsStage, RecStage as JRecStage
from retto_tpu_torch import (
    BucketConfig,
    ClsConfig,
    FakeEngine,
    PipelineMode,
    RecConfig,
    RettoSession,
    SessionConfig,
)
from retto_tpu_torch.errors import RettoError, RettoImageError
from retto_tpu_torch.image.io import ImageHelper
from retto_tpu_torch.ops.charset import CharacterDict
from retto_tpu_torch.pipeline.stages import ClsStage, RecStage

LETTERS = ["a", "b", "c"]
CHARS = CharacterDict(LETTERS)
JCHARS = JChars(LETTERS)
MODES = [PipelineMode.COMPAT, PipelineMode.PERFORMANCE]


def fake(**kw):
    return FakeEngine(rec_classes=CHARS.num_classes, device="cpu", **kw)


def jfake(**kw):
    return JFake(rec_classes=JCHARS.num_classes, **kw)


# --------------------------------------------------- test_compat_semantics.py
def crops_with_ratios(ratios, h=40, helper=ImageHelper):
    return [helper(np.zeros((h, max(int(h * r), 2), 3), np.uint8)) for r in ratios]


def run_stage(stage, jstage, ratios, engine_kw=None):
    """The port's stage and the JAX stage on the same crops; returns the
    port's (engine, output, crops) after holding both to each other."""
    engine, jengine = fake(**(engine_kw or {})), jfake(**(engine_kw or {}))
    crops = crops_with_ratios(ratios)
    jcrops = crops_with_ratios(ratios, helper=JImage)
    out, jout = stage(crops, engine), jstage(jcrops, jengine)
    assert engine.calls == jengine.calls
    assert [vars(o) for o in out] == [vars(o) for o in jout]
    for c, jc in zip(crops, jcrops):
        np.testing.assert_array_equal(c.img, jc.img)
    return engine, out, crops


def rec_stage(mode, ratios, cfg_kw, bucket_kw=None):
    bk = bucket_kw or {}
    return run_stage(
        RecStage(RecConfig(**cfg_kw), BucketConfig(**bk), PipelineMode(mode), CHARS),
        JRecStage(JRecCfg(**cfg_kw), JBucket(**bk), JMode(mode), JCHARS), ratios)


def cls_stage(mode, ratios, cfg_kw, engine_kw=None):
    return run_stage(ClsStage(ClsConfig(**cfg_kw), BucketConfig(), PipelineMode(mode)),
                     JClsStage(JClsCfg(**cfg_kw), JBucket(), JMode(mode)), ratios, engine_kw)


def test_rec_compat_width_is_carried_max_ratio():
    eng, _, _ = rec_stage("compat", [12.0, 3.0, 2.0, 8.0], cfg_kw=dict(batch_num=2))
    rec_calls = [c for c in eng.calls if c[0] == "rec"]
    assert len(rec_calls) == 2
    assert rec_calls[0][1] == (2, 3, 48, 320)
    assert rec_calls[1][1] == (2, 3, 48, 48 * 12)


def test_rec_compat_min_width_is_image_shape():
    eng, _, _ = rec_stage("compat", [2.0, 1.5], cfg_kw=dict(batch_num=6))
    _, shape = [c for c in eng.calls if c[0] == "rec"][0]
    assert shape[3] == 320


def test_cls_compat_chunking_and_shape():
    eng, labels, _ = cls_stage("compat", [5, 4, 3, 2],
                               cfg_kw=dict(batch_num=3, symmetrize=False))
    cls_calls = [c for c in eng.calls if c[0] == "cls"]
    assert [c[1][0] for c in cls_calls] == [3, 1]
    assert all(c[1][1:] == (3, 48, 192) for c in cls_calls)
    assert len(labels) == 4


def test_cls_symmetrize_runs_both_orientations_and_averages():
    eng, labels, crops = cls_stage("compat", [3, 2], cfg_kw=dict(batch_num=6),
                                   engine_kw=dict(cls_probs=(0.03, 0.97)))
    assert len([c for c in eng.calls if c[0] == "cls"]) == 2
    for lab in labels:
        assert abs(lab.score - 0.5) < 1e-6


def test_performance_width_buckets_quantize():
    eng, _, _ = rec_stage("performance", [5.0, 9.0], cfg_kw=dict(batch_num=6),
                          bucket_kw=dict(rec_width_buckets=(320, 640),
                                         rec_batch_buckets=(4,)))
    assert sorted(c[1][3] for c in eng.calls if c[0] == "rec") == [320, 640]


# ------------------------------------------------------------ test_pipeline.py
def make_image(rects, h=256, w=320, encode=True):
    arr = np.zeros((h, w, 3), dtype=np.uint8)
    for (x0, y0, x1, y1) in rects:
        arr[y0:y1, x0:x1] = 255
    if not encode:
        return arr
    buf = io.BytesIO()
    Image.fromarray(arr).save(buf, format="PNG")
    return buf.getvalue()


def make_session(mode=PipelineMode.PERFORMANCE, use_cls=True, symmetrize=False, **kw):
    cfg = SessionConfig(mode=PipelineMode(mode), use_cls=use_cls)
    cfg.cls.symmetrize = symmetrize
    engine = fake(**kw)
    return RettoSession(cfg, engine=engine, charset=CHARS, device="cpu"), engine


def make_jsession(mode, use_cls=True, symmetrize=False, **kw):
    cfg = JConfig(mode=JMode(mode.value), use_cls=use_cls)
    cfg.cls.symmetrize = symmetrize
    engine = jfake(**kw)
    return JSession(cfg, engine=engine, charset=JCHARS), engine


def assert_same_as_jax(data, **kw):
    """The port's result and engine calls equal the JAX session's on
    ``data``, in both modes."""
    for mode in MODES:
        session, engine = make_session(mode, **kw)
        jsession, jengine = make_jsession(mode, **kw)
        assert session.run(data).to_dict() == jsession.run(data).to_dict(), mode
        assert engine.calls == jengine.calls, mode


class TestEndToEnd:
    def test_detects_bright_regions_and_recognizes(self):
        img = make_image([(40, 60, 240, 90), (40, 150, 200, 180)])
        session, engine = make_session()
        res = session.run(img)
        assert len(res.det_result) == 2
        assert len(res.cls_result) == 2
        assert len(res.rec_result) == 2
        assert [t.text for t in res.rec_result] == ["ab", "ab"]
        assert all(t.score > 0.8 for t in res.rec_result)
        stages = [c[0] for c in engine.calls]
        assert stages[0] == "det" and "cls" in stages and "rec" in stages
        assert_same_as_jax(img)

    def test_boxes_in_original_coords(self):
        img = make_image([(400, 600, 2400, 900)], h=2560, w=3200)
        session, _ = make_session()
        res = session.run(img)
        assert len(res.det_result) == 1
        box = res.det_result[0].box
        assert abs(box.tl.x - 400) < 350
        assert abs(box.tl.y - 600) < 350
        assert box.br.x > 2300 and box.br.x < 3199
        assert_same_as_jax(img)

    def test_empty_image_no_boxes(self):
        img = make_image([])
        session, engine = make_session()
        res = session.run(img)
        assert len(res.det_result) == 0
        assert len(res.cls_result) == 0
        assert len(res.rec_result) == 0
        assert [c[0] for c in engine.calls] == ["det"]
        assert_same_as_jax(img)

    def test_cls_rotates_crops_when_180(self):
        img = make_image([(40, 60, 240, 90)])
        session, _ = make_session(cls_probs=(0.02, 0.98))
        res = session.run(img)
        assert res.cls_result[0].label == 180
        assert res.cls_result[0].score == pytest.approx(0.98)
        assert_same_as_jax(img, cls_probs=(0.02, 0.98))

    def test_cls_below_thresh_not_rotated(self):
        img = make_image([(40, 60, 240, 90)])
        session, _ = make_session(cls_probs=(0.15, 0.85))
        res = session.run(img)
        assert res.cls_result[0].label == 180
        assert res.cls_result[0].score == pytest.approx(0.85)
        assert_same_as_jax(img, cls_probs=(0.15, 0.85))

    def test_use_cls_false_skips_cls(self):
        img = make_image([(40, 60, 240, 90)])
        session, engine = make_session(use_cls=False, symmetrize=True)
        res = session.run(img)
        assert len(res.cls_result) == 0
        assert "cls" not in [c[0] for c in engine.calls]
        assert_same_as_jax(img, use_cls=False, symmetrize=True)

    def test_run_stream_stage_order(self):
        img = make_image([(40, 60, 240, 90)])
        session, _ = make_session()
        seen = []
        session.run_stream(img, lambda s: seen.append(s.stage))
        assert seen == ["det", "cls", "rec"]
        jsession, _ = make_jsession(PipelineMode.PERFORMANCE)
        jseen = []
        jsession.run_stream(img, lambda s: jseen.append((s.stage, s.to_dict())))
        got = []
        make_session()[0].run_stream(img, lambda s: got.append((s.stage, s.to_dict())))
        assert got == jseen
        assert_same_as_jax(img)

    def test_raw_ndarray_input(self):
        arr = make_image([(40, 60, 240, 90)], encode=False)
        session, _ = make_session()
        res = session.run(arr)
        assert len(res.det_result) == 1
        assert_same_as_jax(arr)

    def test_json_serialization(self):
        img = make_image([(40, 60, 240, 90)])
        session, _ = make_session()
        res = session.run(img)
        d = res.to_dict()
        assert set(d) == {"det_result", "cls_result", "rec_result"}
        assert "boxes" in d["det_result"][0]
        assert res.to_json()
        assert_same_as_jax(img)


class TestModes:
    @pytest.mark.parametrize("mode", MODES)
    def test_both_modes_same_texts(self, mode):
        img = make_image([(20, 40, 300, 70), (20, 120, 160, 150)])
        session, _ = make_session(mode)
        res = session.run(img)
        assert [t.text for t in res.rec_result] == ["ab", "ab"]
        assert_same_as_jax(img)

    def test_compat_chunks_of_batch_num(self):
        img = make_image([(10, 10 + 34 * i, 250, 38 + 34 * i) for i in range(7)],
                         h=300, w=320)
        session, engine = make_session(PipelineMode.COMPAT)
        session.run(img)
        rec_calls = [c for c in engine.calls if c[0] == "rec"]
        assert len(rec_calls) == 2
        assert rec_calls[0][1][0] == 6 and rec_calls[1][1][0] == 1
        assert_same_as_jax(img)

    def test_performance_batches_padded_to_bucket(self):
        img = make_image([(10, 10 + 34 * i, 250, 38 + 34 * i) for i in range(7)],
                         h=300, w=320)
        session, engine = make_session(PipelineMode.PERFORMANCE)
        res = session.run(img)
        rec_calls = [c for c in engine.calls if c[0] == "rec"]
        assert len(rec_calls) == 1
        assert rec_calls[0][1][0] == 8
        assert len(res.rec_result) == 7
        cls_calls = [c for c in engine.calls if c[0] == "cls"]
        assert len(cls_calls) == 1 and cls_calls[0][1][0] == 8
        jsession, _ = make_jsession(PipelineMode.PERFORMANCE)
        jsession.run(img)
        assert (session.metrics.summary()["bucket_occupancy"]
                == jsession.metrics.summary()["bucket_occupancy"])
        assert_same_as_jax(img)


class TestRunMany:
    def test_batch_and_error_isolation(self):
        session, _ = make_session()
        good = make_image([(40, 60, 240, 90)])
        out = session.run_many([good, b"garbage", good])
        assert len(out) == 3
        assert not isinstance(out[0], RettoError)
        assert isinstance(out[1], RettoError)
        assert not isinstance(out[2], RettoError)
        jout = make_jsession(PipelineMode.PERFORMANCE)[0].run_many([good, b"garbage", good])
        assert out[0].to_dict() == jout[0].to_dict() == out[2].to_dict()
        assert type(out[1]).__name__ == type(jout[1]).__name__

    def test_raise_on_error(self):
        session, _ = make_session()
        with pytest.raises(RettoImageError):
            session.run_many([b"garbage"], raise_on_error=True)
        assert_same_as_jax(make_image([(40, 60, 240, 90)]))
