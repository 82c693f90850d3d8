"""The port's staged ``RettoSession`` (``run``/``run_stream``/``run_many``
over ``TorchEngine``) against the JAX session on the tiny float32
checkpoints (tests/torch_tiny_ckpt.py), COMPAT and PERFORMANCE, on seeded
synthetic pages.

Tolerances: texts, cls labels and box counts equal (17 lines per mode);
boxes within 0.5 px, det and rec scores within 1e-4 (float32 sums in
other orders; measured 0.00 px, 3.0e-8 and 6.0e-8).

Also: ``run_stream``'s det, cls, rec order with results equal to ``run``;
``run_many`` isolating a corrupt input; a session without weights giving a
well-formed result; the session's one dispatch lock, with the staged
path and the fused ``DevicePipeline`` driven from two threads at once; and
the process-wide lock on cuDNN's TF32 flag, with two sessions in two
threads each seeing its own mode's flag at every float32 conv."""

from __future__ import annotations

import threading
import time

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from retto_tpu.config import BucketConfig as JBucket, PipelineMode as JMode
from retto_tpu.config import SessionConfig as JConfig
from retto_tpu.ops.charset import CharacterDict as JChars, ascii_charset
from retto_tpu.pipeline.session import RettoSession as JSession
from retto_tpu_torch import BucketConfig, PipelineMode, RettoSession, SessionConfig
from retto_tpu_torch.errors import RettoError
from retto_tpu_torch.ops.charset import CharacterDict
from torch_tiny_ckpt import configs, write_tiny_checkpoints

BOX_PX, DET_SCORE, REC_SCORE = 0.5, 1e-4, 1e-4


def pages():
    rng = np.random.default_rng(0)
    out = [rng.integers(0, 255, (160, 200, 3), dtype=np.uint8) for _ in range(2)]
    gray = rng.integers(0, 255, (150, 210), dtype=np.uint8)
    bars = np.full((120, 260, 3), 255, np.uint8)
    for y in (20, 60, 90):
        bars[y:y + 14, 20:230] = rng.integers(0, 90, (14, 210, 3), dtype=np.uint8)
    return out + [np.repeat(gray[..., None], 3, axis=2), bars]


@pytest.fixture(scope="module")
def weights(tmp_path_factory):
    return write_tiny_checkpoints(tmp_path_factory.mktemp("tiny_session"))


@pytest.fixture(scope="module")
def sessions(weights):
    built = {}

    def get(mode):
        if mode not in built:
            tcfg = configs(SessionConfig, BucketConfig)
            tcfg.mode = PipelineMode(mode)
            jcfg = configs(JConfig, JBucket)
            jcfg.mode = JMode(mode)
            chars = ascii_charset()
            built[mode] = (
                RettoSession(tcfg, charset=CharacterDict(chars), weights=weights,
                             device="cpu"),
                JSession(jcfg, charset=JChars(chars), weights=weights),
            )
        return built[mode]

    yield get
    for s, js in built.values():
        s.close()
        js.close()


def assert_close(got, ref):
    assert len(got.det_result) == len(ref.det_result)
    for g, r in zip(got.det_result, ref.det_result):
        assert np.abs(np.asarray(g.box.pts) - np.asarray(r.box.pts)).max() <= BOX_PX
        assert abs(g.score - r.score) <= DET_SCORE
    assert [c.label for c in got.cls_result] == [c.label for c in ref.cls_result]
    assert [t.text for t in got.rec_result] == [t.text for t in ref.rec_result]
    for g, r in zip(got.rec_result, ref.rec_result):
        assert abs(g.score - r.score) <= REC_SCORE


@pytest.mark.parametrize("mode", ["compat", "performance"])
def test_staged_session_matches_jax(sessions, mode):
    session, jsession = sessions(mode)
    lines = 0
    for page in pages():
        got, ref = session.run(page), jsession.run(page)
        assert_close(got, ref)
        lines += len(ref.det_result)
    assert lines > 0  # the random det fired: cls and rec ran
    shapes = session.engine.compiled_shapes()
    assert shapes["det"] >= 1 and shapes["rec"] >= 1


def test_run_stream_order_and_run_many_isolation(sessions):
    session, _ = sessions("compat")
    page = pages()[3]
    events = []
    session.run_stream(page, events.append)
    assert [e.stage for e in events] == ["det", "cls", "rec"]
    res = session.run(page)
    assert [e.result.to_dict() for e in events] == [
        res.det_result.to_dict(), res.cls_result.to_dict(), res.rec_result.to_dict()]
    out = session.run_many([page, b"not an image", page])
    assert isinstance(out[1], RettoError)
    assert out[0].to_dict() == out[2].to_dict() == res.to_dict()


def test_random_init_session_gives_a_well_formed_result():
    cfg = configs(SessionConfig, BucketConfig)
    with RettoSession(cfg, device="cpu") as session:
        res = session.run(pages()[0])
    d = res.to_dict()
    assert set(d) == {"det_result", "cls_result", "rec_result"}
    assert len(res.rec_result) == len(res.det_result)
    for b in res.det_result:
        assert np.isfinite(np.asarray(b.box.pts)).all()


def test_staged_and_fused_from_two_threads(sessions):
    """One dispatch lock per session: the staged engine's forwards and the
    fused pipeline's dispatches never run model code at once, and both give
    their single-thread results when driven together."""
    session, _ = sessions("performance")
    assert session.device_pipeline()._lock is session.engine.lock
    imgs = pages()
    staged_ref = [session.run(p).to_dict() for p in imgs]
    fused_ref = [r.to_dict() for r in session.device_pipeline().run_many(imgs)]
    out: dict[str, list] = {}
    errors: list[BaseException] = []
    barrier = threading.Barrier(2)

    def staged():
        barrier.wait()
        out["staged"] = [session.run(p).to_dict() for p in imgs]

    def fused():
        barrier.wait()
        out["fused"] = [r.to_dict() for r in session.device_pipeline().run_many(imgs)]

    def guarded(fn):
        try:
            fn()
        except BaseException as e:  # noqa: BLE001 - reported below
            errors.append(e)

    threads = [threading.Thread(target=guarded, args=(f,)) for f in (staged, fused)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=300)
    assert not errors, errors
    assert out["staged"] == staged_ref
    assert out["fused"] == fused_ref


def test_tf32_flag_per_session_mode_from_two_threads(monkeypatch):
    """Two bf16 sessions in two threads: the fused PERFORMANCE pipeline's
    BatchNorm convs run with cuDNN's TF32 flag True, the staged engine's
    (``full_float32``) with it False, at every float32 conv each launches,
    though the flag is one for the process (``models.common.cudnn_tf32``).
    On the CPU the convs take XLA:CPU's order and skip the flag, so the
    test stands in for the card: the cuDNN check says yes, the CPU orders
    step aside, and a patched ``F.conv2d`` records the flag at its launch
    and again after a pause that leaves the other thread time to change
    it."""
    from retto_tpu_torch.models import common

    monkeypatch.setattr(common, "_uses_cudnn", lambda x: True)
    monkeypatch.setattr(common, "_conv_f32_cpu", lambda *a, **k: None)
    monkeypatch.setattr(common, "_depthwise_f32_cpu", lambda *a, **k: None)
    real = F.conv2d
    seen: dict[str, list[bool]] = {"fused": [], "staged": []}

    def conv(x, *args, **kwargs):
        if x.dtype == torch.float32:
            # the staged session runs on its calling thread, the fused
            # pipeline on its caller and its own upload thread
            name = threading.current_thread().name
            who = seen["staged" if name == "staged" else "fused"]
            who.append(torch.backends.cudnn.allow_tf32)
            time.sleep(2e-4)
            who.append(torch.backends.cudnn.allow_tf32)
        return real(x, *args, **kwargs)

    monkeypatch.setattr(F, "conv2d", conv)
    cfgs = {}
    for mode in ("performance", "compat"):
        cfgs[mode] = SessionConfig()
        cfgs[mode].mode = PipelineMode(mode)
    imgs = pages()
    errors: list[BaseException] = []
    barrier = threading.Barrier(2)
    with RettoSession(cfgs["performance"], preset="tiny", device="cpu") as a, \
            RettoSession(cfgs["compat"], preset="tiny", device="cpu") as b:
        def fused():
            barrier.wait()
            for _ in range(3):
                a.device_pipeline().run_many(imgs)

        def staged():
            barrier.wait()
            for _ in range(3):
                for p in imgs:
                    b.run(p)

        def guarded(fn):
            try:
                fn()
            except BaseException as e:  # noqa: BLE001 - reported below
                errors.append(e)

        threads = [threading.Thread(target=guarded, args=(fn,), name=fn.__name__)
                   for fn in (fused, staged)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=300)
        assert not any(t.is_alive() for t in threads)
    assert not errors, errors
    assert seen["fused"] and set(seen["fused"]) == {True}
    assert seen["staged"] and set(seen["staged"]) == {False}
