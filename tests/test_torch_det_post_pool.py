"""The fused pipeline's det postprocess on its post pool (``DevicePipeline
._post_chunk``, ``_contours``): one ``det_chunk_native`` call an image, on
pool threads, gives bit for bit what one call over the whole chunk gives,
whatever the pool's width; ``run_many`` reads the same at widths 1 and 4;
the calling thread runs none of it; a native exception surfaces from
``run_many``; a one-image ``run`` reads as the serial chunk call and the
JAX pipeline do; threads that load the native library at once all get it.

The pipelines load the tiny float32 checkpoints of
tests/test_torch_pipeline_tiny.py with its permissive det thresholds."""

from __future__ import annotations

import threading
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest

import retto_tpu_torch.native as t_native
from retto_tpu_torch import BucketConfig, RettoSession, SessionConfig
from retto_tpu_torch.geometry import scale_and_clip
from retto_tpu_torch.ops.charset import CharacterDict
from retto_tpu_torch.pipeline import device_pipeline
from retto_tpu.ops.charset import ascii_charset
from test_torch_pipeline_stream import _batches
from test_torch_pipeline_tiny import _images, _configs, pipelines, tiny_weights  # noqa: F401


@pytest.fixture(scope="module")
def tdp(tiny_weights):  # noqa: F811
    session = RettoSession(_configs(SessionConfig, BucketConfig, "yuv420"),
                           charset=CharacterDict(ascii_charset()), weights=tiny_weights,
                           device="cpu")
    dp = session.device_pipeline()
    yield dp
    session.close()


def _pages(seed=11, n=6):
    return _batches(seed, [(160, 200)] * n, 1)[0]


def _capture_chunks(dp, monkeypatch):
    """Record every chunk's ``_post_chunk`` arguments (its key, images and
    maps) as the pipeline makes them."""
    seen = []
    real = dp._post_chunk

    def spy(pool, key, imgs, packed_np, prob_np, sid, ci):
        seen.append((key, list(imgs), packed_np.copy(), prob_np.copy()))
        return real(pool, key, imgs, packed_np, prob_np, sid, ci)

    monkeypatch.setattr(dp, "_post_chunk", spy)
    return seen


def _serial(dp, key, imgs, packed_np, prob_np):
    """The chunk's postprocess as one ``det_chunk_native`` call over all of
    its images."""
    s, det = dp._det_stride, dp.cfg.det
    nb = len(imgs)
    return t_native.det_chunk_native(
        packed_np[:nb], packed_np.shape[1] != key[2] // s, prob_np[:nb],
        [(im.rh // s, im.rw // s) for im in imgs], s,
        [(im.rh, im.rw) for im in imgs], [(im.ah, im.aw) for im in imgs],
        max(1, det.min_mini_box_size // s), det.max_candidates, det.box_thresh,
        det.unclip_ratio, det.min_mini_box_size)


def _same(a, b):
    return a.dtype == b.dtype and a.shape == b.shape and a.tobytes() == b.tobytes()


def _flat(results):
    """Every number of a run's results, for an exact comparison."""
    out = []
    for r in results:
        out.append([(np.asarray(b.box.pts, np.float64).tobytes(), b.score)
                    for b in r.det_result])
        out.append([(c.label, c.score) for c in r.cls_result])
        out.append([(t.text, t.score) for t in r.rec_result])
    return out


@pytest.mark.parametrize("width", [1, 2, 4])
def test_per_image_pool_equals_one_chunk_call(tdp, monkeypatch, width):
    assert t_native.available()
    seen = _capture_chunks(tdp, monkeypatch)
    tdp.run_many(_pages())
    assert len(seen) >= 2 and sum(len(c[1]) for c in seen) == 6
    boxes = 0
    with ThreadPoolExecutor(max_workers=width) as pool:
        for ci, (key, imgs, packed_np, prob_np) in enumerate(seen):
            ref = _serial(tdp, key, imgs, packed_np, prob_np)
            futs = device_pipeline.DevicePipeline._post_chunk(  # not the spy
                tdp, pool, key, imgs, packed_np, prob_np, 0, ci)
            got = [f.result() for f in futs]
            assert len(got) == len(ref) == len(imgs)
            for (rb, rs), (gb, gs, tm), im in zip(ref, got, imgs):
                assert _same(gb, rb) and _same(gs, rs)
                # what the calling thread assigned in the run
                assert _same(im.boxes, rb) and _same(im.scores, rs)
                assert tm.counts["contours"] == 1
                boxes += len(rb)
    assert boxes > 0


def test_run_many_equal_at_widths_1_and_4(tdp, monkeypatch):
    pages = _pages(seed=12, n=7)
    runs = []
    for width in (1, 4):
        pool = ThreadPoolExecutor(max_workers=width)
        monkeypatch.setattr(tdp, "_post_pool", pool)
        try:
            runs.append(tdp.run_many(pages))
        finally:
            pool.shutdown(wait=True)
    assert sum(len(r.det_result) for r in runs[0]) > 0
    assert any(t.text for r in runs[0] for t in r.rec_result)
    assert _flat(runs[0]) == _flat(runs[1])


def test_pool_width_follows_the_chunk_and_the_cpus(monkeypatch):
    monkeypatch.setattr(device_pipeline.os, "sched_getaffinity", lambda _pid: set(range(8)))
    assert device_pipeline._host_threads(4) == 4
    assert device_pipeline._host_threads(8) == 5
    monkeypatch.setattr(device_pipeline.os, "sched_getaffinity", lambda _pid: {0, 1})
    assert device_pipeline._host_threads(4) == 1


def test_postprocess_runs_off_the_calling_thread(tdp, monkeypatch):
    real = t_native.det_chunk_native
    threads = []

    def recording(*a, **kw):
        threads.append(threading.get_ident())
        return real(*a, **kw)

    monkeypatch.setattr(t_native, "det_chunk_native", recording)
    out = tdp.run_many(_pages(seed=13, n=5))
    assert len(threads) == 5  # one call an image
    assert threading.get_ident() not in threads
    assert sum(len(r.det_result) for r in out) > 0
    assert tdp.last_stats["n_contours"] == 5
    assert tdp.last_stats["n_contours_wait"] == tdp.last_stats["chunks"]


def test_native_exception_surfaces_from_run_many(tdp, monkeypatch):
    def boom(*a, **kw):
        raise RuntimeError("det postprocess failed")

    pages = _pages(seed=14, n=3)
    with monkeypatch.context() as m:
        m.setattr(t_native, "det_chunk_native", boom)
        with pytest.raises(RuntimeError, match="det postprocess failed"):
            tdp.run_many(pages)
    # the pipeline runs on
    assert len(tdp.run_many(pages)) == 3


def test_one_image_run_reads_as_the_serial_chunk_call(pipelines, monkeypatch):  # noqa: F811
    jdp, tdp = pipelines("yuv420")
    jdp.cfg.use_cls = tdp.cfg.use_cls = True
    img = _images()[0]
    seen = _capture_chunks(tdp, monkeypatch)
    got = tdp.run(img)
    assert len(seen) == 1 and len(seen[0][1]) == 1
    (im,) = seen[0][1]
    (rb, rs), = _serial(tdp, *seen[0])
    ref_boxes = scale_and_clip(rb, im.aw, im.ah, im.ori_w, im.ori_h)
    assert len(got.det_result) == len(rb) > 0
    for b, rbox, sc in zip(got.det_result, ref_boxes, rs):
        assert np.array_equal(np.asarray(b.box.pts), np.asarray(rbox)) and b.score == float(sc)
    ref = jdp.run(img)
    assert len(ref.det_result) == len(got.det_result)
    for rbox, gbox in zip(ref.det_result, got.det_result):
        assert np.abs(np.asarray(gbox.box.pts) - np.asarray(rbox.box.pts)).max() <= 1.0
    assert [t.text for t in got.rec_result] == [t.text for t in ref.rec_result]
    assert [c.label for c in got.cls_result] == [c.label for c in ref.cls_result]


def test_native_library_loads_once_under_threads(monkeypatch):
    """The post pool's threads may make the first native call together:
    one builds and opens the library, and none reads it as absent
    meanwhile."""
    assert t_native._load() is not None
    monkeypatch.setattr(t_native, "_LIB", None)
    monkeypatch.setattr(t_native, "_TRIED", False)
    real_open, opened = t_native._open, []

    def slow_open():
        opened.append(threading.get_ident())
        time.sleep(0.05)  # hold the window open for the other threads
        return real_open()

    monkeypatch.setattr(t_native, "_open", slow_open)
    with ThreadPoolExecutor(max_workers=8) as pool:
        libs = list(pool.map(lambda _: t_native._load(), range(16), timeout=60))
    assert len(opened) == 1
    assert libs[0] is not None and all(lib is libs[0] for lib in libs)
