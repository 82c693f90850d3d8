"""retto_tpu_torch DevicePipeline (device="cpu") against the JAX
DevicePipeline on the same inputs, at a tiny float32 configuration.

Both load the same self-described checkpoints: small tpu_v2 det, dense cls
and the tiny SVTR rec, random weights from Flax's init (seeded), written to
a temporary directory.  Permissive det thresholds make the random det fire,
so crops go through cls and rec.  Covered: transfer formats gray, yuv420
(via ``transfer_format="yuv420"``) and rgb, with ``use_cls`` on and off.
Tolerance: texts, cls labels and box counts equal; boxes within 1 px."""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from retto_tpu.config import BucketConfig as JBucket, SessionConfig as JConfig
from retto_tpu.models import build_det
from retto_tpu.ops.charset import CharacterDict as JChars, ascii_charset
from retto_tpu.pipeline.session import RettoSession as JSession
from retto_tpu.weights import save_params
from retto_tpu_torch import BucketConfig, RettoSession, SessionConfig
from retto_tpu_torch.ops.charset import CharacterDict
from retto_tpu_torch.ops.db_pack import db_epilogue
from retto_tpu_torch.pipeline import device_pipeline
from retto_tpu_torch.utils.timing import StageTimers
from torch_tiny_ckpt import configs as _configs, write_tiny_checkpoints


@pytest.fixture(scope="module")
def tiny_weights(tmp_path_factory):
    return write_tiny_checkpoints(tmp_path_factory.mktemp("tiny_ckpt"))


def _images():
    rng = np.random.default_rng(0)
    color = [rng.integers(0, 255, (160, 200, 3), dtype=np.uint8) for _ in range(2)]
    gray = rng.integers(0, 255, (150, 210), dtype=np.uint8)
    return color + [np.repeat(gray[..., None], 3, axis=2)]


@pytest.fixture(scope="module")
def pipelines(tiny_weights):
    """(JAX, port) pipelines per transfer format, built once; ``use_cls`` is
    read per call, so one pair serves both settings."""
    built = {}

    def get(transfer):
        if transfer not in built:
            chars = ascii_charset()
            jcfg = _configs(JConfig, JBucket, transfer)
            tcfg = _configs(SessionConfig, BucketConfig, transfer)
            built[transfer] = (
                JSession(jcfg, charset=JChars(chars), weights=tiny_weights)
                .device_pipeline(),
                RettoSession(tcfg, charset=CharacterDict(chars), weights=tiny_weights,
                             device="cpu").device_pipeline(),
            )
        return built[transfer]

    yield get
    for jdp, _ in built.values():
        jdp.close()


@pytest.mark.parametrize("use_cls", [True, False])
@pytest.mark.parametrize("transfer", ["yuv420", "rgb"])
def test_tiny_pipeline_matches_jax(pipelines, transfer, use_cls):
    jdp, tdp = pipelines(transfer)
    jdp.cfg.use_cls = tdp.cfg.use_cls = use_cls
    imgs = _images()
    ref = jdp.run_many(imgs)
    got = tdp.run_many(imgs)
    if transfer == "yuv420":
        assert sorted({k[-1] for k in _formats(tdp, imgs)}) == ["gray", "yuv420"]
    crops = 0
    for r, g in zip(ref, got):
        assert len(g.det_result) == len(r.det_result)
        crops += len(r.det_result)
        for rb, gb in zip(r.det_result, g.det_result):
            assert np.abs(np.asarray(gb.box.pts) - np.asarray(rb.box.pts)).max() <= 1.0
        assert [t.text for t in g.rec_result] == [t.text for t in r.rec_result]
        assert [c.label for c in g.cls_result] == [c.label for c in r.cls_result]
        assert len(g.cls_result) == (len(g.det_result) if use_cls else 0)
    assert crops > 0  # the random det fired: cls and rec were exercised
    assert any(t.text for r in got for t in r.rec_result)


def _formats(dp, imgs):
    return [(dp._decode_one(im)[0].fmt,) for im in imgs]


def test_entry_points_refuse_cuda_without_a_card(tiny_weights):
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    cfg = _configs(SessionConfig, BucketConfig, "yuv420")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        RettoSession(cfg, weights=tiny_weights)


@pytest.mark.parametrize("disabled", [
    ("det_chunk_native",),
    ("det_chunk_native", "pack_auto_native", "is_gray_native", "pack_gray_native",
     "pack_yuv420_native", "det_candidates_native", "det_finalize_native",
     "gray_batch_native", "pack_chunk_native"),
], ids=["det_tail", "all_native"])
def test_fallbacks_without_native_match_jax(pipelines, monkeypatch, disabled):
    """Without the C++ library, the det tail runs on numpy contours and the
    gray/YUV pack on numpy/PIL, in both packages
    (device_pipeline.py:755-773, :1080-1101); the port's fallbacks must read
    the same boxes and texts as the JAX ones."""
    import retto_tpu.native as j_native
    import retto_tpu_torch.native as t_native

    for name in disabled:
        if hasattr(j_native, name):  # the port's call-wide probe and chunk pack
            monkeypatch.setattr(j_native, name, lambda *a, **k: None)
        monkeypatch.setattr(t_native, name, lambda *a, **k: None)
    jdp, tdp = pipelines("yuv420")
    jdp.cfg.use_cls = tdp.cfg.use_cls = True
    imgs = _images()
    ref, got = jdp.run_many(imgs), tdp.run_many(imgs)
    assert sum(len(r.det_result) for r in ref) > 0
    for r, g in zip(ref, got):
        assert len(g.det_result) == len(r.det_result)
        for rb, gb in zip(r.det_result, g.det_result):
            assert np.abs(np.asarray(gb.box.pts) - np.asarray(rb.box.pts)).max() <= 1.0
        assert [t.text for t in g.rec_result] == [t.text for t in r.rec_result]


def test_corrupt_input_is_isolated(pipelines):
    from retto_tpu_torch.errors import RettoError

    _, tdp = pipelines("yuv420")
    good = _images()[0]
    res = tdp.run_many([good, b"not an image", good])
    assert isinstance(res[1], RettoError)
    assert not isinstance(res[0], RettoError) and not isinstance(res[2], RettoError)
    assert [t.text for t in res[0].rec_result] == [t.text for t in res[2].rec_result]
    with pytest.raises(RettoError):
        tdp.run(b"\x00\x01garbage")


def test_wide_line_chunking_and_gather_warp_match_jax(pipelines):
    """``_clsrec_buckets``, ``_dispatch_clsrec`` + ``_fetch_texts`` on
    hand-made crop tasks: a line wider than the largest rec width bucket
    (320 here) splits into overlapping segments whose CTC streams are
    merged on the host
    (device_pipeline.py:1199-1225, :1358-1365); an aligned quad takes the
    separable warp, a tilted one the gather warp."""
    import jax.numpy as jnp

    from retto_tpu.pipeline import device_pipeline as jmod
    from retto_tpu_torch.pipeline import device_pipeline as tmod

    jdp, tdp = pipelines("yuv420")
    jdp.cfg.use_cls = tdp.cfg.use_cls = True
    rng = np.random.default_rng(7)
    imgs = rng.integers(0, 255, (2, 64, 640, 3), dtype=np.uint8)
    imgs[:, 20:40] //= 4  # a dark band the crops cross
    valid = np.asarray([[60, 600], [64, 640]], np.int32)
    quads = [
        (0, [[10, 10], [590, 10], [590, 40], [10, 40]]),  # wide, aligned: k = 4
        (1, [[20, 5], [120, 5], [120, 45], [20, 45]]),  # one segment
        (1, [[12, 14], [600, 24], [599, 54], [11, 44]]),  # wide, tilted: gather
    ]

    def tasks(mod, **kw):
        out = []
        for j, (i, q) in enumerate(quads):
            im = mod._Img(64, 640, 64, 640, 64, 640)
            im.row = i
            q = np.asarray(q, np.float32)
            w = int(max(np.linalg.norm(q[1] - q[0]), np.linalg.norm(q[2] - q[3])))
            h = int(max(np.linalg.norm(q[3] - q[0]), np.linalg.norm(q[2] - q[1])))
            out.append((mod._CropTask(i, j, q, h, w, im=im, **kw), 0))
        return out

    def stats():
        return {"dispatches": 0, "bytes_down": 0, "t_clsrec_fetch": 0.0}

    jt, tt = tasks(jmod, sid=0), tasks(tmod, sid=0)
    jh = jdp._dispatch_clsrec(jnp.asarray(imgs), jnp.asarray(valid), jt, stats())
    jtexts, ttexts = {}, {}
    jdp._fetch_texts(jh, stats(), jtexts)
    with torch.inference_mode():  # run_many's mode around the internals
        base_of, buckets = tdp._clsrec_buckets(tt)
        th = [(items, tdp._dispatch_clsrec({tdp.device: torch.from_numpy(imgs)},
                                           {tdp.device: torch.from_numpy(valid)}, base_of,
                                           bw, aligned, items, stats()))
              for bw, aligned, items in buckets]
        assert max(e[2] for items, _ in th for e in items) == 4  # the wide line split
        tdp._fetch_texts(th, stats(), ttexts, StageTimers(), 0)
    for j in range(len(quads)):
        r, g = jtexts[(0, jt[j][0].img_i, j)], ttexts[(0, tt[j][0].img_i, j)]
        assert g.text == r.text and abs(g.score - r.score) <= 1e-5
        tc, jc = tt[j][0].cls_label, jt[j][0].cls_label
        assert tc.label == jc.label and abs(tc.score - jc.score) <= 1e-5
    assert any(ttexts[k].text for k in ttexts)


def test_stride4_det_takes_the_epilogue_with_pool_1(tiny_weights, tmp_path, monkeypatch):
    """A det whose head emits a stride-4 map (``out_stride=4``) on a
    grid-aligned bucket (map 64 x 128) goes through ``db_epilogue`` with
    pool 1, as the JAX pipeline sends such a map to its Pallas kernel; mask
    and prob map equal the JAX pipeline's ``_det_fwd`` (tiny float32 det,
    seeded init)."""
    arch = dict(backbone="tpu_v2", widths=[16, 32, 48], depths=[1, 1, 1], inner_ch=16,
                head_ch=16, out_stride=4)
    det = build_det("bare", compute_dtype="float32", **arch)
    variables = jax.jit(lambda r, v: det.init(r, v, train=True))(
        jax.random.PRNGKey(3), jnp.zeros((1, 3, 64, 64)))
    weights = dict(tiny_weights, det=str(tmp_path / "det.npz"))
    save_params(weights["det"], variables, meta={"preset": "bare", "overrides": arch})

    def cfg(cls):
        c = cls()
        c.det.limit_side_len = 512
        c.det.thresh = 0.52  # near the random det's median probability
        c.engine.compute_dtype = "float32"
        c.engine.transfer_format = "rgb"
        return c

    chars = ascii_charset()
    tdp = RettoSession(cfg(SessionConfig), charset=CharacterDict(chars),
                       weights=weights, device="cpu").device_pipeline()
    assert tdp._det_stride == 4
    seen = []

    def spy(pred, thresh, dilate, pool, logits):
        seen.append((tuple(pred.shape), pool, logits))
        return db_epilogue(pred, thresh, dilate, pool, logits)

    monkeypatch.setattr(device_pipeline, "db_epilogue", spy)
    rgb = np.random.default_rng(4).integers(0, 255, (256, 512, 3), dtype=np.uint8)
    im, planes = tdp._decode_one(rgb)
    dh, dw = 256, 512
    vs = np.asarray([[im.ah, im.aw]], np.int32)
    vd = np.asarray([[im.rh, im.rw]], np.int32)
    with torch.inference_mode():
        packed, prob, _ = tdp._det_fwd(tuple(torch.from_numpy(p[None]) for p in planes),
                                       torch.from_numpy(vs), torch.from_numpy(vd),
                                       dh, dw, im.fmt)
    assert seen == [((1, 64, 128), 1, True)]
    with JSession(cfg(JConfig), charset=JChars(chars),
                  weights=weights).device_pipeline() as jdp:
        jpacked, jprob, _ = jdp._det_fwd(
            jdp._params["det"], tuple(jnp.asarray(p[None]) for p in planes),
            jnp.asarray(vs), jnp.asarray(vd), dh=dh, dw=dw, fmt=im.fmt)
    assert prob.shape == (1, 64, 128)
    # the JAX CPU path packs along W, the port along rows: compare the bits
    bits = np.unpackbits(packed.numpy(), axis=1)
    np.testing.assert_array_equal(bits, np.unpackbits(np.asarray(jpacked), axis=2))
    np.testing.assert_array_equal(prob.numpy(), np.asarray(jprob))
    assert 0.1 < bits.mean() < 0.9  # a mixed mask: the compare decides pixels
