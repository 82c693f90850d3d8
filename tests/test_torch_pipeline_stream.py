"""The port's DevicePipeline scheduling against the JAX DevicePipeline:
``stream``, ``run_stream``, ``run_many`` with ``stage_callback``, the
cross-shape crop accumulator, ``close()``, ``compile_count()`` and the graph
cache's static outputs.

Both pipelines load the tiny float32 checkpoints of
tests/test_torch_pipeline_tiny.py (random Flax init, seeded) with its
permissive det thresholds, on the CPU.  Tolerance, as there: texts, cls
labels and box counts equal, boxes within 1 px.  The port's CPU graph cache
runs each function eagerly on static buffers that the next call of the same
key overwrites, as a replayed CUDA graph does, so these tests also hold the
pipeline's copies of those outputs."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from retto_tpu.config import BucketConfig as JBucket, SessionConfig as JConfig
from retto_tpu.ops.charset import CharacterDict as JChars, ascii_charset
from retto_tpu.pipeline.session import RettoSession as JSession
from retto_tpu_torch import BucketConfig, RettoSession, SessionConfig
from retto_tpu_torch.ops.charset import CharacterDict
from retto_tpu_torch.pipeline import graphs
from test_torch_pipeline_tiny import _configs, tiny_weights  # noqa: F401 (fixture)

MIXED_SIZES = [(160, 200), (120, 144), (192, 256)]


def _pair(weights, transfer="rgb", **bucket_kw):
    jcfg = _configs(JConfig, JBucket, transfer)
    tcfg = _configs(SessionConfig, BucketConfig, transfer)
    for cfg in (jcfg, tcfg):
        for k, v in bucket_kw.items():
            setattr(cfg.buckets, k, v)
    chars = ascii_charset()
    jdp = JSession(jcfg, charset=JChars(chars), weights=weights).device_pipeline()
    tdp = RettoSession(tcfg, charset=CharacterDict(chars), weights=weights,
                       device="cpu").device_pipeline()
    return jdp, tdp


@pytest.fixture(scope="module")
def pair(tiny_weights):  # noqa: F811
    jdp, tdp = _pair(tiny_weights)
    yield jdp, tdp
    jdp.close()
    tdp.close()


def _batches(seed, sizes, n_batches):
    rng = np.random.default_rng(seed)
    return [[rng.integers(0, 255, (h, w, 3), dtype=np.uint8) for (h, w) in sizes]
            for _ in range(n_batches)]


def _assert_same(ref, got):
    """Per image: box counts, texts and cls labels equal, boxes within 1 px."""
    assert len(got) == len(ref)
    for r, g in zip(ref, got):
        assert len(g.det_result) == len(r.det_result)
        for rb, gb in zip(r.det_result, g.det_result):
            assert np.abs(np.asarray(gb.box.pts) - np.asarray(rb.box.pts)).max() <= 1.0
        assert [t.text for t in g.rec_result] == [t.text for t in r.rec_result]
        assert [c.label for c in g.cls_result] == [c.label for c in r.cls_result]


def test_stream_matches_run_many(pair):
    jdp, tdp = pair
    batches = _batches(1, [(160, 200)] * 2, 3)
    seq = [tdp.run_many(b) for b in batches]
    got = list(tdp.stream(batches))
    ref = list(jdp.stream(batches))
    assert len(got) == len(ref) == 3
    assert sum(len(r.det_result) for b in got for r in b) > 0
    for s, g, r in zip(seq, got, ref):
        _assert_same(s, g)
        _assert_same(r, g)


def test_stream_empty(pair):
    _, tdp = pair
    assert list(tdp.stream([])) == []


def test_mixed_sizes_cross_shape_accumulation(tiny_weights):  # noqa: F811
    """Chunks of different upload shapes accumulate into one crop bucket
    through the device edge pad + concat, without changing any result, and
    the port reads what the JAX pipeline's ``stream`` reads."""
    jdp, tdp = _pair(tiny_weights)
    with jdp, tdp:
        batches = _batches(7, MIXED_SIZES, 3)
        seq = [tdp.run_many(b) for b in batches]
        assert any(len(r.det_result) for b in seq for r in b)
        before = tdp.metrics.pad_concats
        got = list(tdp.stream(batches))
        assert tdp.metrics.pad_concats > before  # the mixed-shape path ran
        ref = list(jdp.stream(batches))
        for s, g, r in zip(seq, got, ref):
            _assert_same(s, g)
            _assert_same(r, g)
        assert tdp.compile_count() > 0


def test_stage_callback_order_matches_jax(pair):
    jdp, tdp = pair
    imgs = _batches(3, [(160, 200), (150, 210), (160, 200)], 1)[0]
    events = {"jax": [], "port": []}
    ref = jdp.run_many(imgs, lambda i, ev: events["jax"].append((i, ev)))
    got = tdp.run_many(imgs, lambda i, ev: events["port"].append((i, ev)))
    _assert_same(ref, got)
    assert [(i, ev.stage) for i, ev in events["port"]] == \
        [(i, ev.stage) for i, ev in events["jax"]]
    for i in range(len(imgs)):
        stages = [ev.stage for k, ev in events["port"] if k == i]
        assert stages == ["det", "cls", "rec"]
    for (_, ev), (_, jev) in zip(events["port"], events["jax"]):
        if ev.stage == "rec":
            assert [t.text for t in ev.result] == [t.text for t in jev.result]
        if ev.stage == "det":
            assert len(ev.result) == len(jev.result)


def test_run_stream_matches_jax(pair):
    jdp, tdp = pair
    img = _batches(4, [(160, 200)], 1)[0][0]
    jev, tev = [], []
    ref = jdp.run_stream(img, jev.append)
    got = tdp.run_stream(img, tev.append)
    _assert_same([ref], [got])
    assert [e.stage for e in tev] == [e.stage for e in jev] == ["det", "cls", "rec"]


def test_close_is_idempotent_and_context_managers_close(tiny_weights):  # noqa: F811
    cfg = _configs(SessionConfig, BucketConfig, "rgb")
    chars = CharacterDict(ascii_charset())
    with RettoSession(cfg, charset=chars, weights=tiny_weights, device="cpu") as session:
        dp = session.device_pipeline()
        assert session.device_pipeline() is dp
    assert session._device_pipeline is None
    session.close()  # idempotent, also with no pipeline left
    with pytest.raises(RuntimeError):  # the pools are shut down
        dp.run_many(_batches(5, [(160, 200)], 1)[0])
    dp.close()
    dp.close()
    with dp as same:
        assert same is dp
    other = RettoSession(cfg, charset=chars, weights=tiny_weights,
                         device="cpu").device_pipeline()
    with other:
        assert len(other.run_many(_batches(5, [(160, 200)], 1)[0])) == 1
    with pytest.raises(RuntimeError):
        other.run_many(_batches(5, [(160, 200)], 1)[0])


def test_compile_count_grows_only_on_a_new_key(tiny_weights):  # noqa: F811
    cfg = _configs(SessionConfig, BucketConfig, "rgb")
    imgs = _batches(6, [(160, 200)] * 2, 1)[0]
    with RettoSession(cfg, charset=CharacterDict(ascii_charset()), weights=tiny_weights,
                      device="cpu").device_pipeline() as tdp:
        assert tdp.compile_count() == 0
        tdp.run_many(imgs)
        n = tdp.compile_count()
        assert n >= 2  # one det chunk key and at least one cls + rec bucket
        tdp.run_many(imgs)
        tdp.run_many(imgs[::-1])
        assert tdp.compile_count() == n
        tdp.run_many(_batches(6, [(192, 256)], 1)[0])  # another upload shape
        assert tdp.compile_count() > n


def test_static_outputs_are_copied_before_the_next_replay(tiny_weights, monkeypatch):  # noqa: F811
    """Four pages in two det chunks of one key (det_chunk 2): chunk 2's
    call overwrites the det maps that chunk 1's postprocess reads and the
    image tensor that chunk 1's crops still need, so the pipeline must
    have copied them.  Results equal
    those of the eager path, which calls each function directly."""
    cfg = _configs(SessionConfig, BucketConfig, "yuv420")
    cfg.buckets.det_chunk = 2
    chars = CharacterDict(ascii_charset())
    imgs = _batches(8, [(160, 200)] * 4, 1)[0]
    with RettoSession(cfg, charset=chars, weights=tiny_weights,
                      device="cpu").device_pipeline() as tdp:
        # run_many, with both chunks dispatched before chunk 1 is read
        state = tdp._prepare(imgs)
        for ch in state["chunks"]:
            ch.upload_fut.result()
        got = tdp._finish(state)
        assert tdp.last_stats["chunks"] == 2 and len(tdp._det_graphs) == 1
    monkeypatch.setattr(graphs.GraphCache, "run",
                        lambda self, key, fn, *args: tuple(fn(*args)))
    with RettoSession(cfg, charset=chars, weights=tiny_weights,
                      device="cpu").device_pipeline() as edp:
        ref = edp.run_many(imgs)
    assert sum(len(r.det_result) for r in ref[:2]) > 0  # chunk 1 has crops
    for r, g in zip(ref, got):
        assert [(np.asarray(b.box.pts).tolist(), b.score) for b in g.det_result] == \
            [(np.asarray(b.box.pts).tolist(), b.score) for b in r.det_result]
        assert [(t.text, t.score) for t in g.rec_result] == \
            [(t.text, t.score) for t in r.rec_result]


def test_graph_cache_on_cpu_reuses_static_buffers():
    """The CPU entry of a key copies new arguments into its static inputs
    and writes its outputs into the same static tensors on every call."""
    cache = graphs.GraphCache(torch.device("cpu"))
    calls = []

    def fn(x, y):
        calls.append((x.data_ptr(), y.data_ptr()))
        return x + y, x * 2

    a = cache.run("k", fn, torch.ones(3), torch.full((3,), 2.0))
    b = cache.run("k", fn, torch.zeros(3), torch.ones(3))
    assert len(cache) == 1
    assert calls[0] == calls[1]  # the same static inputs
    assert a[0] is b[0] and a[1] is b[1]  # the same static outputs, overwritten
    assert b[0].tolist() == [1.0] * 3 and b[1].tolist() == [0.0] * 3
    cache.run("other", fn, torch.ones(2), torch.ones(2))
    assert len(cache) == 2
