"""The port's meshes and data-parallel inference against the JAX package,
on the CPU (the cases of tests/test_parallel.py): ``make_mesh`` and
``shard_batch``; ``TorchEngine(mesh=)`` over a mesh that names the CPU 8
times against the mesh-free engine and the JAX ``JaxEngine(mesh=
make_mesh(8))`` (8 virtual CPU devices) on the same tiny weights;
``DevicePipeline`` over that mesh against the JAX sharded pipeline and
the port's mesh-free pipeline on the tiny checkpoints, by
tests/test_parallel.py's rule: equal box counts, boxes within 1e-3, equal
texts; the det epilogue once per shard of each det chunk; the staged
session over the mesh.

Bits may differ between the sharded and the mesh-free runs: the port's CPU
path follows XLA's sum orders, some of which depend on the batch
(``models.common._xla_dot_order`` reads M), and a shard is a smaller
batch.  Measured on the three images of
``test_device_pipeline_mesh_matches_jax_and_single``: 0 px between the
port's sharded run and the JAX sharded run, and 0 px between the port's
sharded and mesh-free runs; texts equal."""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from retto_tpu.config import BucketConfig as JBucket, SessionConfig as JConfig
from retto_tpu.models import build_cls as j_cls
from retto_tpu.ops.charset import CharacterDict as JChars, ascii_charset
from retto_tpu.parallel import make_mesh as j_make_mesh
from retto_tpu.pipeline.engine import JaxEngine
from retto_tpu.pipeline.session import RettoSession as JSession
from retto_tpu.weights import init_random_params
from retto_tpu.weights.store import _flatten
from retto_tpu_torch import BucketConfig, RettoSession, SessionConfig, TorchEngine
from retto_tpu_torch.models import build_cls
from retto_tpu_torch.ops.charset import CharacterDict
from retto_tpu_torch.parallel import data_sharding, make_mesh, replicate, shard_batch
from retto_tpu_torch.pipeline import device_pipeline
from retto_tpu_torch.weights import load_flax_params
from torch_tiny_ckpt import configs as _configs, write_tiny_checkpoints

CPU8 = [torch.device("cpu")] * 8


def test_make_mesh_shapes(monkeypatch):
    m = make_mesh(8, devices=CPU8)
    assert m.shape == {"data": 8, "model": 1} and m.size == 8
    m2 = make_mesh(8, model_parallel=4, devices=CPU8)
    assert m2.shape == {"data": 2, "model": 4}
    assert m2.devices.shape == (2, 4)
    with pytest.raises(ValueError):
        make_mesh(6, model_parallel=4, devices=CPU8)
    # no devices named: every CUDA card, and none here is an error, never a CPU mesh
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_mesh()


def test_shard_batch_places_on_all_devices():
    mesh = make_mesh(devices=CPU8)
    x = torch.arange(16 * 4, dtype=torch.float32).reshape(16, 4)
    parts = shard_batch(mesh, x)
    assert len(parts) == 8 and all(p.shape == (2, 4) for p in parts)
    assert torch.equal(torch.cat(parts), x)
    assert data_sharding(mesh).devices == CPU8
    assert all(torch.equal(p, x) for p in replicate(mesh).put(x))
    with pytest.raises(ValueError, match="does not split"):
        shard_batch(mesh, x[:3])  # pads are the caller's job, as in JAX


@pytest.fixture(scope="module")
def tiny_cls():
    model = j_cls("tiny", compute_dtype=None)
    params = init_random_params(model, jnp.zeros((1, 3, 32, 64)))
    port = load_flax_params(build_cls("tiny", compute_dtype=None), _flatten(params)).eval()
    return model, params, port


def test_torch_engine_data_parallel_inference(tiny_cls):
    _, _, port = tiny_cls
    eng = TorchEngine(cls_model=port, mesh=make_mesh(devices=CPU8))
    out = eng.cls(np.zeros((16, 3, 32, 64), np.float32))  # 2 rows per device
    assert out.shape == (16, 2)
    np.testing.assert_allclose(out.sum(-1).numpy(), 1.0, atol=1e-5)


def test_sharded_engine_equals_single_device_and_jax(tiny_cls):
    model, params, port = tiny_cls
    x = np.random.default_rng(0).normal(size=(8, 3, 32, 64)).astype(np.float32)
    jsharded = np.asarray(JaxEngine(cls_model=model, cls_params=params,
                                    mesh=j_make_mesh(8)).cls(x))
    single = TorchEngine(cls_model=port, device="cpu").cls(x).numpy()
    sharded = TorchEngine(cls_model=port, mesh=make_mesh(devices=CPU8)).cls(x).numpy()
    np.testing.assert_allclose(sharded, single, atol=1e-5)
    np.testing.assert_allclose(sharded, jsharded, atol=1e-5)
    # a batch the data size does not divide runs on the first devices
    three = TorchEngine(cls_model=port, mesh=make_mesh(devices=CPU8)).cls(x[:3]).numpy()
    np.testing.assert_allclose(three, single[:3], atol=1e-5)


@pytest.fixture(scope="module")
def tiny_weights(tmp_path_factory):
    return write_tiny_checkpoints(tmp_path_factory.mktemp("tiny_ckpt_mesh"))


def _images():
    rng = np.random.default_rng(0)
    color = [rng.integers(0, 255, (160, 200, 3), dtype=np.uint8) for _ in range(2)]
    gray = rng.integers(0, 255, (150, 210), dtype=np.uint8)
    return color + [np.repeat(gray[..., None], 3, axis=2)]


def _lines(results):
    return [([np.asarray(d.box.pts, np.float64) for d in r.det_result],
             [t.text for t in r.rec_result]) for r in results]


def _assert_same(a, b, atol=1e-3) -> None:
    for (ba, ta), (bb, tb) in zip(a, b):
        assert len(ba) == len(bb)
        for pa, pb in zip(ba, bb):
            np.testing.assert_allclose(pa, pb, atol=atol)
        assert ta == tb


def test_device_pipeline_mesh_matches_jax_and_single(tiny_weights):
    """The fused pipeline over 8 'data' devices against the JAX sharded
    pipeline (8 virtual CPU devices) and the port's mesh-free one."""
    chars = ascii_charset()
    jcfg = _configs(JConfig, JBucket)
    tcfg = _configs(SessionConfig, BucketConfig)
    imgs = _images()
    with JSession(jcfg, charset=JChars(chars), weights=tiny_weights,
                  mesh=j_make_mesh(8)) as js:
        jres = _lines(js.device_pipeline().run_many(imgs))
    tchars = CharacterDict(chars)
    with RettoSession(tcfg, charset=tchars, weights=tiny_weights, device="cpu") as single, \
            RettoSession(tcfg, charset=tchars, weights=tiny_weights,
                         mesh=make_mesh(devices=CPU8)) as sharded:
        one = _lines(single.device_pipeline().run_many(imgs))
        dp = sharded.device_pipeline()
        got = _lines(dp.run_many(imgs))
        # det and crop buckets are multiples of the data size
        assert all(total % 8 == 0 for _, total in dp.metrics.bucket_fill.values())
    assert sum(len(b) for b, _ in got) > 0 and sum(len(t) for _, t in got) > 0
    _assert_same(got, one)
    _assert_same(got, jres)


def test_det_epilogue_runs_once_per_shard(tiny_weights, monkeypatch):
    """Each det chunk's shards run the det forward and the epilogue on
    their own rows: over 'data' = 4 the epilogue runs 4 times per chunk,
    on a quarter of the bucket each."""
    calls = []
    real = device_pipeline.db_epilogue

    def counting(pred, *a, **kw):
        calls.append(tuple(pred.shape))
        return real(pred, *a, **kw)

    monkeypatch.setattr(device_pipeline, "db_epilogue", counting)
    cfg = _configs(SessionConfig, BucketConfig)
    cfg.det.limit_side_len = 256  # a 128 x 256 det map, the kernel's grid
    cfg.buckets.det_chunk = 2
    rng = np.random.default_rng(1)
    imgs = [rng.integers(0, 255, (128, 256, 3), dtype=np.uint8) for _ in range(3)]
    chars = CharacterDict(ascii_charset())
    with RettoSession(cfg, charset=chars, weights=tiny_weights, device="cpu") as single, \
            RettoSession(cfg, charset=chars, weights=tiny_weights,
                         mesh=make_mesh(devices=[torch.device("cpu")] * 4)) as sharded:
        one = single.device_pipeline().run_many(imgs)
        n_single = len(calls)
        calls.clear()
        got = sharded.device_pipeline().run_many(imgs)
    chunks = 2  # 3 images in chunks of 2
    assert n_single == chunks
    assert len(calls) == 4 * chunks and all(s[0] == 1 for s in calls)
    _assert_same(_lines(got), _lines(one))


def test_staged_session_over_mesh_equals_single(tiny_weights):
    """``RettoSession(mesh=).run``: the staged engine splits each stage's
    batch (one det image per call runs on the first device)."""
    cfg = _configs(SessionConfig, BucketConfig)
    chars = CharacterDict(ascii_charset())
    single = RettoSession(cfg, charset=chars, weights=tiny_weights, device="cpu")
    sharded = RettoSession(cfg, charset=chars, weights=tiny_weights,
                           mesh=make_mesh(devices=CPU8))
    imgs = _images()
    a = _lines([single.run(x) for x in imgs])
    b = _lines([sharded.run(x) for x in imgs])
    assert sum(len(t) for _, t in a) > 0
    _assert_same(b, a)
    assert sharded.engine.compiled_shapes() == single.engine.compiled_shapes()


def test_stream_over_mesh_equals_run_many(tiny_weights):
    """``stream`` over the mesh (crops of several chunks and batches, of two
    upload shapes, meet in each device's pad + concat) gives ``run_many``'s
    results per batch."""
    cfg = _configs(SessionConfig, BucketConfig)
    cfg.buckets.det_chunk = 1
    rng = np.random.default_rng(2)
    batches = [[rng.integers(0, 255, s, dtype=np.uint8) for s in shapes]
               for shapes in (((160, 200, 3), (96, 256, 3)), ((150, 210, 3),))]
    with RettoSession(cfg, charset=CharacterDict(ascii_charset()), weights=tiny_weights,
                      mesh=make_mesh(devices=[torch.device("cpu")] * 2)) as session:
        dp = session.device_pipeline()
        ref = [_lines(dp.run_many(b)) for b in batches]
        pads = dp.metrics.pad_concats
        got = [_lines(out) for out in dp.stream(batches)]
        assert dp.metrics.pad_concats > pads
    assert sum(len(b) for r in ref for b, _ in r) > 0
    for r, g in zip(ref, got):
        _assert_same(g, r)
