"""The fused pipeline's page packing in two native calls: one gray probe
over a call's pages (``native.gray_batch_native``, ``rt_gray_batch``) and
one pack a det chunk straight into its stacked upload planes
(``native.pack_chunk_native``, ``rt_pack_chunk``), each threaded over the
pages.  Held bit for bit to the per-page calls they replace
(``is_gray_native``, ``pack_auto_native``) and, through ``run_many``, to
the pipeline with the two wrappers returning None, whose pages take the
per-page probe and pack.

The pipelines load the tiny float32 checkpoints of
tests/test_torch_pipeline_tiny.py with its permissive det thresholds."""

from __future__ import annotations

import io

import numpy as np
import pytest

import retto_tpu_torch.native as t_native
from retto_tpu.ops.charset import ascii_charset
from retto_tpu_torch import BucketConfig, RettoSession, SessionConfig
from retto_tpu_torch.ops.charset import CharacterDict
from test_torch_pipeline_tiny import _configs, tiny_weights  # noqa: F401 (fixture)


def _gray(rng, h, w):
    return np.repeat(rng.integers(0, 256, (h, w, 1), dtype=np.uint8), 3, axis=2)


def _color(rng, h, w):
    return rng.integers(0, 256, (h, w, 3), dtype=np.uint8)


def _one_off(rng, h, w):
    """A gray page but for one channel of one pixel, near its end."""
    page = _gray(rng, h, w)
    page[h - 1, w // 3, 1] ^= 1
    return page


PROBE_CASES = {
    "gray": lambda rng: _gray(rng, 96, 128),
    "color": lambda rng: _color(rng, 96, 128),
    "one_pixel_differs": lambda rng: _one_off(rng, 96, 128),
    "odd_gray": lambda rng: _gray(rng, 37, 53),
    "odd_color": lambda rng: _color(rng, 37, 53),
    "odd_one_pixel_differs": lambda rng: _one_off(rng, 37, 53),
    "one_pixel": lambda rng: _gray(rng, 1, 1),
}


@pytest.mark.parametrize("case", sorted(PROBE_CASES))
def test_probe_reads_as_the_per_page_calls(case):
    rng = np.random.default_rng(sorted(PROBE_CASES).index(case))
    page = PROBE_CASES[case](rng)
    # the probe over a call of pages: this page among gray and colour ones
    pages = [_gray(rng, 40, 30), page, _color(rng, 20, 50), page]
    got = t_native.gray_batch_native(pages, 3)
    want = [t_native.is_gray_native(p) for p in pages]
    assert got == want
    h, w = page.shape[:2]
    auto = t_native.pack_auto_native(page, h + h % 2, w + w % 2)
    assert got[1] == auto[0] == (case in ("gray", "odd_gray", "one_pixel"))


def test_probe_of_no_pages_and_of_other_shapes():
    assert t_native.gray_batch_native([], 4) == []
    assert t_native.gray_batch_native([np.zeros((4, 4), np.uint8)], 1) is None


def _per_page(pages, hp, wp, nb, gray):
    """What the pipeline uploaded before: each page's ``pack_auto_native``
    planes stacked into ``np.zeros`` (``device_pipeline._stack``)."""
    outs = [t_native.pack_auto_native(p, hp, wp) for p in pages]
    assert all(o[0] == gray for o in outs)
    planes = [o[1:2] if gray else o[1:] for o in outs]
    stacked = []
    for k in range(len(planes[0])):
        buf = np.zeros((nb, *planes[0][k].shape), np.uint8)
        for r, pl in enumerate(planes):
            buf[r] = pl[k]
        stacked.append(buf)
    return stacked


@pytest.mark.parametrize("threads", [1, 2, 4])
@pytest.mark.parametrize("fmt", ["gray", "yuv420"])
def test_chunk_pack_is_the_stacked_per_page_pack(fmt, threads):
    rng = np.random.default_rng(threads)
    make = _gray if fmt == "gray" else _color
    hp, wp = 128, 192
    # full-size pages, pages smaller than the extent (an odd one among
    # them), and a partial chunk whose last rows are padding
    sizes = [(128, 192), (101, 150), (128, 77), (64, 192), (33, 35)]
    pages = [make(rng, h, w) for h, w in sizes]
    for n, nb in ((5, 5), (3, 8), (1, 4)):
        got = t_native.pack_chunk_native(pages[:n], hp, wp, nb, fmt == "gray", threads)
        want = _per_page(pages[:n], hp, wp, nb, fmt == "gray")
        assert len(got) == len(want) == (1 if fmt == "gray" else 2)
        for g, w in zip(got, want):
            assert g.shape == w.shape and g.dtype == np.uint8
            np.testing.assert_array_equal(g, w)
        assert not got[0][n:].any()


def test_chunk_pack_refuses_what_it_cannot_take():
    page = np.zeros((8, 8, 3), np.uint8)
    assert t_native.pack_chunk_native([page], 8, 9, 1, True, 1) is None  # odd extent
    assert t_native.pack_chunk_native([page], 6, 8, 1, True, 1) is None  # page too tall
    assert t_native.pack_chunk_native([page, page], 8, 8, 1, True, 1) is None  # nb < n
    assert t_native.pack_chunk_native([page[..., 0]], 8, 8, 1, True, 1) is None


def _session(weights, **bucket_kw):
    cfg = _configs(SessionConfig, BucketConfig, "yuv420")
    for k, v in bucket_kw.items():
        setattr(cfg.buckets, k, v)
    cfg.use_cls = True
    return RettoSession(cfg, charset=CharacterDict(ascii_charset()), weights=weights,
                        device="cpu")


def _mixed_pages(seed, sizes):
    """Gray and colour pages of each size, interleaved."""
    rng = np.random.default_rng(seed)
    return [(_gray if k % 2 else _color)(rng, h, w) for k, (h, w) in enumerate(sizes)]


def _flat(results):
    return [([np.asarray(b.box.pts).tolist() for b in r.det_result],
             [float(b.score) for b in r.det_result],
             [(c.label, float(c.score)) for c in r.cls_result],
             [(t.text, float(t.score)) for t in r.rec_result]) for r in results]


def _without_chunk_pack(monkeypatch):
    for name in ("gray_batch_native", "pack_chunk_native"):
        monkeypatch.setattr(t_native, name, lambda *a, **k: None)


# two sizes, gray and colour: four chunk keys, a full chunk among them;
# then, at an upload pad of 1, gray pages of odd extents, which take the
# per-page pack, beside colour pages of even ones, which take the chunk pack
# (a colour page of odd extents has no YUV 4:2:0 planes, either way)
RUN_CASES = {
    "two_sizes": (dict(), [(160, 200), (120, 144)] * 5, 10),
    "odd_extents": (dict(upload_pad_to=1), [(120, 144), (161, 201), (120, 144), (121, 143)] * 2,
                    4),
}


@pytest.mark.parametrize("case", sorted(RUN_CASES))
def test_run_many_reads_as_without_the_chunk_pack(tiny_weights, monkeypatch, case):  # noqa: F811
    bucket_kw, sizes, native_pages = RUN_CASES[case]
    pages = _mixed_pages(5, sizes)
    with _session(tiny_weights, **bucket_kw) as session:
        dp = session.device_pipeline()
        got = dp.run_many(pages)
        st = dict(dp.last_stats)
        assert st["pages_packed_native"] == native_pages
        assert dp.metrics.pages_packed_native == native_pages
        assert dp.metrics.summary()["pages_packed_native"] == native_pages
        # a probe each det chunk of pages (4), a pack each chunk
        assert st["n_gray_probe"] == -(-len(pages) // 4) and st["n_pack"] == st["chunks"]
        with monkeypatch.context() as m:
            _without_chunk_pack(m)
            ref = dp.run_many(pages)
            ref_st = dict(dp.last_stats)
    assert ref_st["pages_packed_native"] == 0
    # without the library the same probes and packs run page by page
    assert ref_st["n_gray_probe"] == st["n_gray_probe"]
    assert ref_st["n_pack"] == ref_st["chunks"]
    assert ref_st["chunks"] == st["chunks"] and ref_st["bytes_up"] == st["bytes_up"]
    assert sum(len(r.det_result) for r in ref) > 0
    assert any(t.text for r in ref for t in r.rec_result)
    assert _flat(got) == _flat(ref)


def test_a_refused_chunk_pack_packs_page_by_page(tiny_weights, monkeypatch):  # noqa: F811
    """The probe ran, but the chunk pack returns None (as for odd extents):
    the upload thread packs the chunk's pages one by one, and the results
    do not change."""
    pages = _mixed_pages(4, [(160, 200), (120, 144)] * 3)
    with _session(tiny_weights) as session:
        dp = session.device_pipeline()
        ref = dp.run_many(pages)
        monkeypatch.setattr(t_native, "pack_chunk_native", lambda *a, **k: None)
        got = dp.run_many(pages)
        st = dict(dp.last_stats)
    assert st["n_gray_probe"] == 2 and st["n_pack"] == st["chunks"]
    assert st["pages_packed_native"] == 0
    assert _flat(got) == _flat(ref)


def _png(page):
    from PIL import Image

    buf = io.BytesIO()
    Image.fromarray(page).save(buf, format="PNG")
    return buf.getvalue()


def test_encoded_pages_are_probed_a_chunk_at_a_time(tiny_weights):  # noqa: F811
    """The probe runs as soon as the pages awaiting it fill a det chunk (4
    here), arrays and encoded bytes alike, so 9 pages take 3 probes, and
    the results of the encoded pages are those of the same pixels given as
    arrays."""
    pages = _mixed_pages(6, [(160, 200)] * 9)
    with _session(tiny_weights) as session:
        dp = session.device_pipeline()
        ref = dp.run_many(pages)
        assert dp.last_stats["n_gray_probe"] == 3
        got = dp.run_many([_png(p) for p in pages])
        st = dict(dp.last_stats)
    assert st["n_gray_probe"] == 3 and st["pages_packed_native"] == 9
    assert _flat(got) == _flat(ref)


def test_stream_reads_a_batch_before_taking_the_next(tiny_weights):  # noqa: F811
    """The pages are packed on the upload thread, after ``_prepare`` has
    returned: ``stream`` advances its iterator only once they are read,
    so a source that refills the arrays it yielded streams what it
    yielded."""
    batches = [_mixed_pages(seed, [(160, 200), (120, 144)] * 3) for seed in (7, 8, 9)]
    buf = [np.empty_like(p) for p in batches[0]]

    def refilled():
        for b in batches:
            for dst, src in zip(buf, b):
                dst[...] = src
            yield buf

    with _session(tiny_weights) as session:
        dp = session.device_pipeline()
        ref = [dp.run_many(b) for b in batches]
        got = list(dp.stream(refilled()))
        assert dp.last_stats["pages_packed_native"] == len(buf)
    assert sum(len(r.det_result) for b in ref for r in b) > 0
    for r, g in zip(ref, got):
        assert _flat(g) == _flat(r)
