"""retto_tpu_torch small device ops against their JAX counterparts.

Integer outputs (CTC indices, keep masks, packed masks) must be equal; the
CTC score (a mean in float32) to 1e-6 relative.
Float outputs: the warp matrices and the gather warp to 1e-4 absolute on
0..255 pixel values (float32 arithmetic in the same order), YUV -> RGB and
the det resize matrices to 1e-4 absolute."""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from retto_tpu.image.warp import _axis_matrix as j_axis, warp_crops_multi as j_warp
from retto_tpu.image.yuv import (
    rgb_to_yuv420 as j_rgb_to_yuv420,
    yuv420_to_rgb_device as j_yuv420_to_rgb,
    yuv_planes_to_rgb as j_planes,
)
from retto_tpu.ops.ctc import ctc_greedy_decode as j_ctc
from retto_tpu.ops.db_post import (
    binarize_dilate as j_bd,
    binarize_dilate_packed as j_bdp,
)
from retto_tpu.pipeline import device_pipeline as jdp
from retto_tpu_torch.image.warp import _axis_matrix, warp_crops_multi
from retto_tpu_torch.image.yuv import rgb_to_yuv420, yuv420_to_rgb_device, yuv_planes_to_rgb
from retto_tpu_torch.ops.ctc import ctc_greedy_decode
from retto_tpu_torch.ops.db_post import binarize_dilate, binarize_dilate_packed, unpack_mask
from retto_tpu_torch.pipeline import device_pipeline as tdp


def _probs(rng, n, t, c, ties=False):
    logits = rng.normal(size=(n, t, c)).astype(np.float32)
    if ties:  # duplicated maxima: argmax must take the first index
        logits = np.round(logits, 0)
    p = np.exp(logits)
    return (p / p.sum(-1, keepdims=True)).astype(np.float32)


@pytest.mark.parametrize("ties", [False, True])
@pytest.mark.parametrize("with_valid", [False, True])
def test_ctc_greedy_decode_exact(with_valid, ties):
    rng = np.random.default_rng(0)
    probs = _probs(rng, 5, 40, 12, ties)
    probs[:, ::3, 0] = 1.0  # blanks between repeats
    valid = np.asarray([40, 10, 0, 33, 1], np.int32) if with_valid else None
    ref = j_ctc(jnp.asarray(probs), valid_t=None if valid is None else jnp.asarray(valid))
    got = ctc_greedy_decode(torch.from_numpy(probs),
                            valid_t=None if valid is None else torch.from_numpy(valid))
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(ref[0]))  # indices
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(ref[1]))  # keep mask
    # mean of the kept probabilities: summation order only
    np.testing.assert_allclose(got[2].numpy(), np.asarray(ref[2]), rtol=1e-6)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("dilate", [True, False])
def test_db_post_exact(dilate, dtype):
    rng = np.random.default_rng(1)
    x = rng.normal(size=(1, 1, 48, 100)).astype(np.float32)
    jx, tx = jnp.asarray(x), torch.from_numpy(x)
    if dtype == "bfloat16":
        jx, tx = jx.astype(jnp.bfloat16), tx.to(torch.bfloat16)
    t = float(np.log(0.3 / 0.7))
    np.testing.assert_array_equal(binarize_dilate(tx, t, dilate).numpy(),
                                  np.asarray(j_bd(jx, t, dilate)))
    packed = binarize_dilate_packed(tx, t, dilate).numpy()
    np.testing.assert_array_equal(packed, np.asarray(j_bdp(jx, t, dilate)))
    assert packed.shape == (48, 13)
    np.testing.assert_array_equal(unpack_mask(packed, 100),
                                  np.asarray(j_bd(jx, t, dilate)).astype(bool))


def test_axis_matrix_and_flip():
    """Against ``_axis_matrix`` as the JAX package runs it, inside a jitted
    warp (XLA fuses ``o + d*s`` into one multiply-add): bit for bit."""
    rng = np.random.default_rng(2)
    o = rng.uniform(-3, 40, 6).astype(np.float32)
    s = rng.uniform(-1.5, 1.5, 6).astype(np.float32)
    valid = rng.integers(20, 64, 6).astype(np.float32)
    rw, rm = jax.jit(j_axis, static_argnums=(2, 3))(jnp.asarray(o), jnp.asarray(s), 64, 49,
                                                     jnp.asarray(valid))
    gw, gm = _axis_matrix(torch.from_numpy(o), torch.from_numpy(s), 64, 49,
                          torch.from_numpy(valid))
    np.testing.assert_array_equal(gw.numpy(), np.asarray(rw))
    np.testing.assert_array_equal(gm.numpy(), np.asarray(rm))


def test_gather_warp_fills_255_against_valid_extent():
    """Taps outside valid_hw take the fill even where the padded tensor
    holds pixels (the bucket padding)."""
    rng = np.random.default_rng(3)
    imgs = rng.integers(0, 255, (2, 40, 56, 3), dtype=np.uint8)
    valid = np.asarray([[30, 44], [40, 56]], np.int32)
    idx = np.asarray([0, 1, 0], np.int32)
    h = np.tile(np.eye(3, dtype=np.float32)[None], (3, 1, 1))
    h[0, :2, 2] = (20.0, 12.0)  # shifted: runs past valid w=44 into padding
    h[1] = [[0.9, 0.2, 3.0], [-0.1, 1.1, 2.0], [1e-3, 0.0, 1.0]]  # perspective
    h[2, :2, :2] = [[-1.0, 0.0], [0.0, -1.0]]  # 180 degrees: all out of range
    h[2, :2, 2] = (43.0, 29.0)
    ref = np.asarray(j_warp(jnp.asarray(imgs), jnp.asarray(idx), jnp.asarray(h),
                            jnp.asarray(valid), 24, 64, fill=255.0))
    got = warp_crops_multi(torch.from_numpy(imgs), torch.from_numpy(idx),
                           torch.from_numpy(h), torch.from_numpy(valid), 24, 64,
                           fill=255.0).numpy()
    np.testing.assert_allclose(got, ref, atol=1e-4)
    assert (got[0, :, 30:] == 255.0).all()  # x >= 44 - 20 + 1 is fill


def test_yuv_to_rgb():
    rng = np.random.default_rng(4)
    rgb = rng.integers(0, 255, (2, 32, 48, 3), dtype=np.uint8)
    planes = [j_rgb_to_yuv420(im) for im in rgb]
    for im, (y, uv) in zip(rgb, planes):
        gy, guv = rgb_to_yuv420(im)
        np.testing.assert_array_equal(gy, y)
        np.testing.assert_array_equal(guv, uv)
    y = np.stack([p[0] for p in planes])
    uv = np.stack([p[1] for p in planes])
    ref = np.asarray(j_yuv420_to_rgb(jnp.asarray(y), jnp.asarray(uv)))
    got = yuv420_to_rgb_device(torch.from_numpy(y), torch.from_numpy(uv)).numpy()
    np.testing.assert_allclose(got, ref, atol=1e-4)
    f = rng.uniform(0, 255, (3, 8, 8)).astype(np.float32)
    np.testing.assert_allclose(
        yuv_planes_to_rgb(*map(torch.from_numpy, f)).numpy(),
        np.asarray(j_planes(*map(jnp.asarray, f))), atol=1e-4)


@pytest.mark.parametrize("replicate", [True, False])
def test_det_resize_matrices(replicate):
    sv = np.asarray([960.0, 500.0], np.float32)
    dv = np.asarray([992.0, 1024.0], np.float32)
    ref = np.asarray(jax.jit(jdp._bilinear_matrix, static_argnums=(2, 3, 4))(
        jnp.asarray(sv), jnp.asarray(dv), 960, 1024, replicate))
    got = tdp._bilinear_matrix(torch.from_numpy(sv), torch.from_numpy(dv), 960, 1024,
                               replicate).numpy()
    np.testing.assert_allclose(got, ref, atol=1e-4)
    img = np.random.default_rng(5).integers(0, 255, (2, 960, 40, 1), dtype=np.uint8)
    ww = np.tile(np.eye(40, dtype=np.float32)[None], (2, 1, 1))
    r2 = np.asarray(jdp._resize2(jnp.asarray(ref), jnp.asarray(ww), jnp.asarray(img))
                    .astype(jnp.float32))
    g2 = tdp._resize2(torch.from_numpy(got), torch.from_numpy(ww),
                      torch.from_numpy(img)).float().numpy()
    assert g2.shape == r2.shape == (2, 1024, 40, 1)
    # bf16 outputs: equal up to one bf16 step of the 0..255 range
    assert np.abs(g2 - r2).max() <= 1.0
