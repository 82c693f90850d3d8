"""The port's ``image/ops.py`` against ``retto_tpu/image/ops.py`` called
eagerly, as the staged det calls it (retto_tpu/pipeline/stages.py:86-88).

Tolerances:
* ``normalize_det`` and ``pad_to`` (both modes): bit-equal.  Eager JAX runs
  each op on its own, so ``x*scale``, ``-mean`` and ``/std`` each round; a
  fused multiply-add (the fused pipeline's normalize, where XLA fuses the
  jit) differs from it on these inputs, which the test also shows.
* ``resize_image`` / ``resize_norm_pad``: the same triangle weights,
  contracted in another order: within 1e-3 on [0, 255] pixel values
  (measured 4.6e-5) and 1e-5 on normalized values (measured 3.5e-6)."""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from retto_tpu.image import ops as jops
from retto_tpu_torch.image import ops

RNG = np.random.default_rng(0)
IMG = RNG.integers(0, 256, (37, 53, 3), dtype=np.uint8)
MEAN, STD = (0.485, 0.456, 0.406), (0.229, 0.224, 0.225)


@pytest.mark.parametrize("mean,std,bgr", [((0.5,) * 3, (0.5,) * 3, True),
                                          (MEAN, STD, True), (MEAN, STD, False)])
def test_normalize_det_bit_equal_to_eager_jax(mean, std, bgr):
    ref = np.asarray(jops.normalize_det(jnp.asarray(IMG), mean, std, 1.0 / 255.0, bgr))
    got = ops.normalize_det(torch.from_numpy(IMG), mean, std, 1.0 / 255.0, bgr).numpy()
    assert got.shape == ref.shape == (1, 3, 37, 53)
    np.testing.assert_array_equal(got.view(np.uint32), ref.view(np.uint32))


def test_normalize_det_rounds_each_op_not_a_fused_multiply_add():
    """Eager JAX is op by op: the fused form ``x*(scale/std) - mean/std``
    rounded once (float64 then float32) differs on these inputs, so the
    bit equality above pins the op-by-op order."""
    ref = np.asarray(jops.normalize_det(jnp.asarray(IMG), MEAN, STD, 1.0 / 255.0))
    x = IMG[..., ::-1].astype(np.float64)
    m, s = np.float32(MEAN).astype(np.float64), np.float32(STD).astype(np.float64)
    fused = ((x * np.float32(1.0 / 255.0) - m) / s).astype(np.float32)
    fused = np.transpose(fused, (2, 0, 1))[None]
    assert int((fused != ref).sum()) > 0


@pytest.mark.parametrize("mode", ["constant", "edge"])
def test_pad_to_bit_equal(mode):
    x = RNG.normal(size=(1, 3, 5, 7)).astype(np.float32)
    ref = np.asarray(jops.pad_to(jnp.asarray(x), 9, 12, value=-1.0, mode=mode))
    got = ops.pad_to(torch.from_numpy(x), 9, 12, value=-1.0, mode=mode).numpy()
    np.testing.assert_array_equal(got, ref)
    assert ops.pad_to(torch.from_numpy(x), 5, 7) is not None
    with pytest.raises(ValueError):
        ops.pad_to(torch.from_numpy(x), 4, 7)


@pytest.mark.parametrize("out_hw", [(20, 31), (37, 53), (74, 90), (48, 17)],
                         ids=["down", "same", "up", "mixed"])
def test_resize_image_against_jax(out_hw):
    ref = np.asarray(jops.resize_image(jnp.asarray(IMG), *out_hw))
    got = ops.resize_image(torch.from_numpy(IMG), *out_hw).numpy()
    assert got.shape == ref.shape == (*out_hw, 3)
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-3)


@pytest.mark.parametrize("resized_w,target_w", [(40, 64), (160, 160)])
def test_resize_norm_pad_against_jax(resized_w, target_w):
    ref = np.asarray(jops.resize_norm_pad(jnp.asarray(IMG), 48, resized_w, target_w))
    got = ops.resize_norm_pad(torch.from_numpy(IMG), 48, resized_w, target_w).numpy()
    assert got.shape == ref.shape == (3, 48, target_w)
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-5)
    assert (got[:, :, resized_w:] == 0).all()
