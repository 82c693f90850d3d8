"""The port's engines against ``retto_tpu/pipeline/engine.py``.

* ``FakeEngine``: the same closed-form outputs (bit-equal) and the same
  ``calls`` as JAX's on the same inputs.
* ``TorchEngine`` against ``JaxEngine`` on the tiny float32 checkpoints
  (tests/torch_tiny_ckpt.py), both built by their package's session: det
  prob map within 1e-5, cls probabilities within 1e-5, rec probabilities
  within 1e-4 of JAX's (absolute; float32 sums in other orders); equal
  ``compiled_shapes()`` counts after the same calls; a padded PERFORMANCE
  batch gives its real rows the bits of the unpadded batch.
* Random initialisation draws from a fixed-seed generator, never from the
  global RNG."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from retto_tpu.config import BucketConfig as JBucket, SessionConfig as JConfig
from retto_tpu.ops.charset import CharacterDict as JChars, ascii_charset
from retto_tpu.pipeline.engine import FakeEngine as JFake
from retto_tpu.pipeline.session import RettoSession as JSession
from retto_tpu_torch import BucketConfig, FakeEngine, RettoSession, SessionConfig, TorchEngine
from retto_tpu_torch.errors import RettoEngineError
from retto_tpu_torch.ops.charset import CharacterDict
from torch_tiny_ckpt import configs, write_tiny_checkpoints

RNG = np.random.default_rng(0)
SHAPES = {"det": [(1, 3, 64, 128), (1, 3, 128, 64)], "cls": [(4, 3, 48, 192)],
          "rec": [(4, 3, 48, 320), (2, 3, 48, 320)]}
ATOL = {"det": 1e-5, "cls": 1e-5, "rec": 1e-4}


@pytest.mark.parametrize("kw", [{}, {"cls_probs": (0.2, 0.8), "rec_indices": (3, 0, 3, 5)},
                                {"det_fn": lambda x: x[:, :1] * 0.5}])
def test_fake_engine_equals_jax(kw):
    t, j = FakeEngine(device="cpu", **kw), JFake(**kw)
    for stage, shape in (("det", (1, 3, 16, 24)), ("cls", (3, 3, 48, 192)),
                         ("rec", (2, 3, 48, 80)), ("rec", (1, 3, 48, 16))):
        x = RNG.uniform(-1, 1, shape).astype(np.float32)
        got = getattr(t, stage)(torch.from_numpy(x))
        ref = np.asarray(getattr(j, stage)(x))
        assert isinstance(got, torch.Tensor) and got.device.type == "cpu"
        np.testing.assert_array_equal(got.numpy(), ref)
    assert t.calls == j.calls


@pytest.fixture(scope="module")
def engines(tmp_path_factory):
    weights = write_tiny_checkpoints(tmp_path_factory.mktemp("tiny_engine"))
    chars = ascii_charset()
    jsession = JSession(configs(JConfig, JBucket), charset=JChars(chars), weights=weights)
    session = RettoSession(configs(SessionConfig, BucketConfig), charset=CharacterDict(chars),
                           weights=weights, device="cpu")
    return session.engine, jsession.engine


@pytest.mark.parametrize("stage", ["det", "cls", "rec"])
def test_torch_engine_matches_jax_engine(engines, stage):
    eng, jeng = engines
    for shape in SHAPES[stage]:
        x = RNG.uniform(-1, 1, shape).astype(np.float32)
        got = getattr(eng, stage)(x)
        ref = np.asarray(getattr(jeng, stage)(x))
        assert isinstance(got, torch.Tensor) and got.dtype == torch.float32
        assert tuple(got.shape) == ref.shape
        np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=ATOL[stage])
    assert eng.compiled_shapes()[stage] == jeng.compiled_shapes()[stage] == len(SHAPES[stage])


def test_compiled_shapes_count_distinct_shapes(engines):
    eng, _ = engines
    before = eng.compiled_shapes()
    x = np.zeros(SHAPES["cls"][0], np.float32)
    eng.cls(x)
    eng.cls(x)
    assert eng.compiled_shapes() == before | {"cls": max(before["cls"], 1)}
    eng.cls(np.zeros((8, 3, 48, 192), np.float32))
    assert eng.compiled_shapes()["cls"] == max(before["cls"], 1) + 1


@pytest.mark.parametrize("stage", ["cls", "rec"])
def test_padded_batch_keeps_real_rows_bits(engines, stage):
    """PERFORMANCE pads a batch with zero rows up to its bucket: the real
    rows must come out with the same bits as the unpadded batch's."""
    eng, _ = engines
    x = RNG.uniform(-1, 1, (3, 3, 48, 192 if stage == "cls" else 320)).astype(np.float32)
    padded = np.concatenate([x, np.zeros((5, *x.shape[1:]), np.float32)])
    a = getattr(eng, stage)(x).numpy()
    b = getattr(eng, stage)(padded).numpy()[:3]
    np.testing.assert_array_equal(a.view(np.uint32), b.view(np.uint32))


def test_missing_stage_model_raises():
    eng = TorchEngine(device="cpu")
    assert eng.compiled_shapes() == {}
    with pytest.raises(RettoEngineError, match="no 'det' model"):
        eng.det(np.zeros((1, 3, 32, 32), np.float32))


def test_random_init_is_seeded_and_leaves_the_global_rng(caplog):
    torch.manual_seed(123)
    expect = torch.rand(4)
    torch.manual_seed(123)
    a = RettoSession(configs(SessionConfig, BucketConfig), device="cpu")
    after = torch.rand(4)
    b = RettoSession(configs(SessionConfig, BucketConfig), device="cpu")
    assert torch.equal(after, expect)
    assert "RANDOM weights" in caplog.text
    for kind in ("det", "cls", "rec"):
        sa = a.engine.modules()[kind].state_dict()
        sb = b.engine.modules()[kind].state_dict()
        assert all(torch.equal(sa[k], sb[k]) for k in sa)
