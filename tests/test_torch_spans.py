"""The port's spans (``utils.timing.StageTimers``) inside the fused
``DevicePipeline`` on the CPU: the keys of ``last_stats``, what they cover,
the profiler gate, the ranges ``profile_trace`` records on every thread, and
the benchmark's readers of the new keys.

The pipeline loads the tiny float32 checkpoints of
tests/test_torch_pipeline_tiny.py with its permissive det thresholds, so
crops reach cls and rec."""

from __future__ import annotations

import json

import numpy as np
import pytest
import torch

from benchmark import run as bench_run
from retto_tpu.ops.charset import ascii_charset
from retto_tpu_torch import BucketConfig, RettoSession, SessionConfig
from retto_tpu_torch.ops.charset import CharacterDict
from retto_tpu_torch.utils.metrics import profile_trace
from retto_tpu_torch.utils.timing import StageTimers
from test_torch_pipeline_stream import MIXED_SIZES, _batches
from test_torch_pipeline_tiny import _configs, tiny_weights  # noqa: F401 (fixture)

# the calling thread's spans, one after another over a run_many call
CALLING = ("decode", "upload_wait", "mask_fetch", "contours_wait", "score", "flush",
           "clsrec_dispatch", "clsrec_wait", "texts", "assemble")
# spans of the other threads (the post pool's contours, one an image), merged
# into the call's
WORKERS = ("upload", "fetch", "lock_wait", "contours")
# spans inside others under the yuv420 transfer: the format probe in the
# calling thread's decode, a chunk's native pack in the upload thread's upload
NESTED = {"gray_probe": "decode", "pack": "upload"}
NEW_READERS = ("host.upload_ms_per_page", "host.lock_wait_ms_per_page",
               "host.device_wait_ms_per_page", "host.flush_ms_per_page",
               "host.clsrec_dispatch_ms_per_page", "host.contours_wait_ms_per_page")
DEVICE_READERS = ("device.det_ms_per_page", "device.clsrec_ms_per_page")


def _pipeline(weights, transfer):
    session = RettoSession(_configs(SessionConfig, BucketConfig, transfer),
                           charset=CharacterDict(ascii_charset()), weights=weights,
                           device="cpu")
    return session, session.device_pipeline()


@pytest.fixture(scope="module")
def tdp(tiny_weights):  # noqa: F811
    session, dp = _pipeline(tiny_weights, "rgb")
    yield dp
    session.close()


@pytest.fixture(scope="module")
def ydp(tiny_weights):  # noqa: F811
    session, dp = _pipeline(tiny_weights, "yuv420")
    yield dp
    session.close()


def _run(dp, seed=1, sizes=((160, 200),) * 3):
    out = dp.run_many(_batches(seed, list(sizes), 1)[0])
    return out, dict(dp.last_stats)


def test_every_span_key_is_in_last_stats(tdp):
    out, st = _run(tdp)
    assert sum(len(r.det_result) for r in out) > 0  # crops reached cls + rec
    for name in CALLING + WORKERS:
        assert isinstance(st[f"t_{name}"], float) and st[f"t_{name}"] >= 0.0, name
        assert st[f"n_{name}"] >= 1, name
    # no card: no device timing events
    assert "t_det_device" not in st and "t_clsrec_device" not in st


def test_old_keys_keep_their_meaning(tdp):
    out, st = _run(tdp, seed=2)
    for k in ("images", "crops", "chunks", "bytes_up", "bytes_down", "dispatches",
              "t_decode", "t_upload_wait", "t_mask_fetch", "t_contours", "t_score",
              "t_clsrec_fetch", "t_total"):
        assert k in st, k
    assert st["images"] == 3
    assert st["crops"] == sum(len(r.det_result) for r in out)
    # one decode span a call; the chunk spans once a chunk; contours once a
    # decoded image, on the post pool
    assert st["n_decode"] == 1
    for name in ("upload_wait", "mask_fetch", "contours_wait", "score", "fetch"):
        assert st[f"n_{name}"] == st["chunks"], name
    assert st["n_contours"] == st["images"]
    # the upload thread: stacking, then the dispatch under the lock
    assert st["n_upload"] == 2 * st["chunks"]
    # a det dispatch a chunk, a cls + rec dispatch a bucket
    assert st["dispatches"] == st["chunks"] + st["n_clsrec_dispatch"]
    assert st["t_clsrec_fetch"] == st["t_clsrec_wait"] + st["t_texts"]
    assert st["pad_concats"] == 0


def test_calling_thread_spans_fit_in_the_call(tdp):
    _, st = _run(tdp, seed=3)
    covered = sum(st[f"t_{name}"] for name in CALLING)
    assert 0.0 < covered <= st["t_total"]


def test_metrics_stage_time_reads_the_same_totals(tdp):
    m = tdp.metrics
    before = dict(m.stage_time)
    _, st = _run(tdp, seed=4)
    for name in CALLING + WORKERS:
        assert m.stage_time[name] - before.get(name, 0.0) == pytest.approx(st[f"t_{name}"])
    assert m.stage_time["clsrec_fetch"] - before.get("clsrec_fetch", 0.0) == \
        pytest.approx(st["t_clsrec_fetch"])


def test_pack_spans_nest_in_decode_and_upload(ydp, tdp):
    out, st = _run(ydp, seed=10, sizes=MIXED_SIZES)
    assert sum(len(r.det_result) for r in out) > 0
    # one probe a det chunk of pages (4), one pack a chunk, each inside its
    # thread's span
    assert st["n_gray_probe"] == 1 and st["n_pack"] == st["chunks"] > 1
    for name, outer in NESTED.items():
        assert 0.0 < st[f"t_{name}"] <= st[f"t_{outer}"], name
    assert st["n_upload"] == 2 * st["chunks"]
    assert st["pages_packed_native"] == st["images"] == len(MIXED_SIZES)
    covered = sum(st[f"t_{name}"] for name in CALLING)
    assert 0.0 < covered <= st["t_total"]
    # the rgb transfer needs no probe, and its chunks are packed page by
    # page on the upload thread
    _, st = _run(tdp, seed=10)
    assert st["pages_packed_native"] == 0 and "t_gray_probe" not in st
    assert 0.0 < st["t_pack"] <= st["t_upload"] and st["n_pack"] == st["chunks"]


def test_profile_trace_records_the_pack_spans_on_their_threads(ydp, tmp_path):
    with profile_trace(str(tmp_path)):
        _run(ydp, seed=11)
    events = json.loads((tmp_path / "trace.json").read_text())["traceEvents"]
    tids: dict[str, set] = {}
    for e in events:
        name = str(e.get("name", ""))
        if name.startswith("retto."):
            tids.setdefault(name.split(" ")[0], set()).add(e["tid"])
    assert tids["retto.gray_probe"] == tids["retto.decode"]
    assert tids["retto.pack"] <= tids["retto.upload"]
    assert tids["retto.pack"].isdisjoint(tids["retto.decode"])


def test_pad_concats_count_mixed_shape_flushes(tdp):
    m0 = tdp.metrics.pad_concats
    _, st = _run(tdp, seed=7, sizes=MIXED_SIZES)
    assert st["pad_concats"] >= 1 and st["chunks"] > 1
    assert tdp.metrics.pad_concats == m0 + st["pad_concats"]
    assert tdp.metrics.summary()["pad_concats"] == tdp.metrics.pad_concats


def test_no_profiler_no_record_function(tdp, monkeypatch):
    entered = []
    real = torch.profiler.record_function

    def counting(*a, **kw):
        entered.append(a)
        return real(*a, **kw)

    monkeypatch.setattr(torch.profiler, "record_function", counting)
    _run(tdp, seed=5)
    assert entered == []
    timers = StageTimers()
    with timers.time("x", sid=1):
        pass
    assert entered == [] and timers.counts["x"] == 1


def test_profile_trace_records_spans_of_every_thread(tdp, tmp_path):
    with profile_trace(str(tmp_path)):
        _run(tdp, seed=6)
    sid = tdp._sid - 1
    events = json.loads((tmp_path / "trace.json").read_text())["traceEvents"]
    tids: dict[str, set] = {}
    for e in events:
        name = str(e.get("name", ""))
        if name.startswith("retto."):
            tids.setdefault(name.split(" ")[0], set()).add(e["tid"])
            assert f"sid={sid}" in name.split(" ")[1:], name
    assert {"retto.decode", "retto.upload", "retto.fetch", "retto.assemble",
            "retto.contours", "retto.contours_wait"} <= set(tids)
    assert tids["retto.decode"].isdisjoint(tids["retto.upload"])
    assert tids["retto.upload"].isdisjoint(tids["retto.fetch"])
    assert tids["retto.decode"] == tids["retto.assemble"] == tids["retto.contours_wait"]
    assert tids["retto.contours"].isdisjoint(
        tids["retto.decode"] | tids["retto.upload"] | tids["retto.fetch"])


def test_stage_timers_add_merge_and_flatten():
    a, b = StageTimers(), StageTimers()
    with a.time("x"):
        pass
    b.add("x", 0.5, 2)
    b.add("dev", 0.25)
    a.merge(b)
    st = a.stats()
    assert st["n_x"] == 3 and st["t_x"] >= 0.5
    assert st["t_dev"] == 0.25 and st["n_dev"] == 1
    assert set(a.summary()) == {"x", "dev"}


def test_span_is_counted_when_its_body_raises():
    t = StageTimers()
    with pytest.raises(ValueError):
        with t.time("boom"):
            raise ValueError
    assert t.counts["boom"] == 1


def test_new_readers_read_a_cpu_run(tdp):
    stats: dict = {}
    pages = 0
    for seed in (8, 9):
        _, st = _run(tdp, seed=seed)
        bench_run._sum_stats(stats, st)
        pages += st["images"]
    ctx = {"pages": pages, "stats": stats}
    for name in NEW_READERS:
        v = bench_run.read_metric(name, ctx)
        assert isinstance(v, float) and np.isfinite(v) and v >= 0.0, name
    assert bench_run.read_metric("host.device_wait_ms_per_page", ctx) == pytest.approx(
        (stats["t_upload_wait"] + stats["t_mask_fetch"] + stats["t_clsrec_wait"])
        / pages * 1e3)
    assert bench_run.read_metric("host.contours_wait_ms_per_page", ctx) == pytest.approx(
        stats["t_contours_wait"] / pages * 1e3)
    for name in DEVICE_READERS:
        assert bench_run.read_metric(name, ctx) is None, name
    # a program without the spans: every new reader finds nothing
    old = {k: stats[k] for k in ("t_decode", "t_upload_wait", "t_mask_fetch",
                                 "t_contours", "t_score", "t_clsrec_fetch", "t_total")}
    for name in NEW_READERS + DEVICE_READERS:
        assert bench_run.read_metric(name, {"pages": pages, "stats": old}) is None, name
