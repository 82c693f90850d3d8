"""retto_tpu_torch.ops.db_pack.db_epilogue: the det epilogue (mask and
pooled prob map in one pass).  Its plain PyTorch version is bit-equal to
the JAX package: the mask to the Pallas kernel it replaces
(``binarize_dilate_pack_rows_batch``, run in interpret mode as
tests/test_pallas_pack.py runs it), the prob map to the pipeline's own
expression (``retto_tpu/pipeline/device_pipeline.py:462`` and ``:490-495``),
compiled by XLA on the CPU.  Tolerance: none, every byte equal.

The CUDA kernel runs only on a card: its test is marked ``cuda`` and skips
here; ``chip_smoke.py`` holds it to the plain version on the H100."""

from __future__ import annotations

import math
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from retto_tpu.ops.pallas.db_pack import binarize_dilate_pack_rows_batch as j_batch
from retto_tpu_torch.ops.db_pack import (
    binarize_dilate_pack_rows_batch,
    db_epilogue,
    db_epilogue_plain,
    pooled_prob_plain,
    tile_edge_pixels,
)

LOGIT_T = math.log(0.3 / 0.7)
# Start torch's intra-op threads before any JAX computation in this
# process: threads that torch starts after one (a Pallas kernel in
# interpret mode, a jit) have computed one chunk of the first elementwise op
# 1 ulp off (~1 run in 3), which moves a few pooled bytes by 1.  Nothing of
# the kind happens without JAX in the process, as on the card.
torch.exp(torch.ones(1 << 16))
# maps with one pixel above the threshold at each edge of every tile the
# CUDA kernel stages (``tile_edge_pixels``): B = 1, 5, 2; H = 64, 1024;
# W = 128, 384, 1024
EDGE_SHAPES = ((1, 64, 128), (5, 64, 384), (1, 1024, 1024))


@partial(jax.jit, static_argnames=("pool", "logits"))
def _jax_prob(pred, pool: int, logits: bool):
    """The JAX pipeline's pooled prob map (device_pipeline.py:462, 490-495)."""
    prob_map = jax.nn.sigmoid(pred) if logits else pred
    summed = jax.lax.reduce_window(
        prob_map.astype(jnp.float32), 0.0, jax.lax.add,
        window_dimensions=(1, pool, pool), window_strides=(1, pool, pool),
        padding="VALID",
    ) * (255.0 / (pool * pool))
    return jnp.clip(jnp.rint(summed), 0, 255).astype(jnp.uint8)


def _both(x: np.ndarray, thresh: float, dilate: bool, pool: int, logits: bool,
          bf16: bool):
    jx, tx = jnp.asarray(x), torch.from_numpy(x)
    if bf16:
        jx, tx = jx.astype(jnp.bfloat16), tx.to(torch.bfloat16)
    ref = (np.asarray(j_batch(jx, thresh, dilate, interpret=True)),
           np.asarray(_jax_prob(jx, pool, logits)))
    got = tuple(t.numpy() for t in db_epilogue_plain(tx, thresh, dilate, pool, logits))
    return ref, got


def _maps(seed: int, shape, logits: bool) -> np.ndarray:
    x = np.random.default_rng(seed).normal(size=shape) * 4
    return (x if logits else 1.0 / (1.0 + np.exp(-x))).astype(np.float32)


@pytest.mark.parametrize("logits", [True, False])
@pytest.mark.parametrize("pool", [1, 2, 4])
@pytest.mark.parametrize("bf16", [True, False], ids=["bf16", "f32"])
def test_plain_equals_jax(bf16, pool, logits):
    x = _maps(pool + 2 * logits, (2, 128, 256), logits)
    thresh = LOGIT_T if logits else 0.3
    (ref_mask, ref_prob), (mask, prob) = _both(x, thresh, True, pool, logits, bf16)
    assert mask.shape == (2, 16, 256) and prob.shape == (2, 128 // pool, 256 // pool)
    np.testing.assert_array_equal(mask, ref_mask)
    np.testing.assert_array_equal(prob, ref_prob)


def test_main_shape_seeded_logits():
    """The main path's shape: 4 pages of stride-2 logits of a 1024x768
    bucket.  0 of 196,608 pooled bytes differ; the exact sigmoid that the
    port took before (``torch.sigmoid``, rounded once) differs on tens of
    thousands, because XLA:CPU rounds ``exp`` and ``1 + exp`` to bf16."""
    x = _maps(0, (4, 512, 384), True)
    (ref_mask, ref_prob), (mask, prob) = _both(x, LOGIT_T, True, 2, True, True)
    np.testing.assert_array_equal(mask, ref_mask)
    assert prob.size == 49_152 * 4 and int((prob != ref_prob).sum()) == 0
    exact = torch.sigmoid(torch.from_numpy(x).to(torch.bfloat16)).float()
    old = exact.reshape(4, 256, 2, 192, 2).sum(dim=(2, 4)) * 63.75
    old = torch.clamp(torch.round(old), 0, 255).to(torch.uint8).numpy()
    assert int((old != ref_prob).sum()) > 10_000


def _edge_map(shape, logits: bool, seed: int = 0) -> np.ndarray:
    """A background below the threshold (logits in [-8, -1.2], or
    probabilities in [0, 0.28]) with one pixel above it (2.0, or 0.9) at
    each edge of every tile the CUDA kernel stages."""
    u = np.random.default_rng(seed).uniform(size=shape)
    x = -8.0 + 6.8 * u if logits else 0.28 * u
    x[tile_edge_pixels(shape)] = 2.0 if logits else 0.9
    return x.astype(np.float32)


_HALO_PARAMS = [pytest.param(pool, None, id=str(pool)) for pool in (1, 2, 4)] + [
    pytest.param(pool, shape, id=f"{pool}-edges-{'x'.join(map(str, shape))}")
    for shape in EDGE_SHAPES for pool in (1, 2, 4)]


@pytest.mark.parametrize("pool, edge_shape", _HALO_PARAMS)
def test_halo_cases(pool, edge_shape):
    """Row 8r-1 (the halo row of the next packed row), column 0, the last
    row of a 64-row tile, the bottom-right corner, and a column a lane's
    first column takes its left neighbour from.  With ``edge_shape``: a
    pixel at each edge of every tile the CUDA kernel stages, in every mode
    (bf16/f32, logits on/off, dilate on/off), against the Pallas kernel in
    interpret mode and the JAX pipeline's prob map."""
    if edge_shape is not None:
        for logits in (True, False):
            x = _edge_map(edge_shape, logits)
            thresh = LOGIT_T if logits else 0.3
            for bf16 in (True, False):
                for dilate in (True, False):
                    (ref_mask, ref_prob), (mask, prob) = _both(x, thresh, dilate, pool,
                                                               logits, bf16)
                    np.testing.assert_array_equal(mask, ref_mask)
                    np.testing.assert_array_equal(prob, ref_prob)
                    # each pixel sets its own bit and, dilated, those below
                    # and to the right of it that lie in the image
                    _, ys, xs = tile_edge_pixels(edge_shape)
                    _, h, w = edge_shape
                    want = ((1 + (ys + 1 < h)) * (1 + (xs + 1 < w))).sum() if dilate else len(ys)
                    assert np.unpackbits(mask, axis=1).sum() == want
        return
    x = np.full((2, 128, 256), -6.0, np.float32)
    x[0, 63, 100] = 2.0
    x[1, 7, 0] = 2.0
    x[1, 15, 8] = 2.0
    x[1, 127, 255] = 2.0
    (ref_mask, ref_prob), (mask, prob) = _both(x, LOGIT_T, True, pool, True, False)
    np.testing.assert_array_equal(mask, ref_mask)
    np.testing.assert_array_equal(prob, ref_prob)
    bits = np.unpackbits(mask[1], axis=0)
    assert bits[7, 0] and bits[8, 0] and bits[8, 1] and bits[7, 1]  # the 2x2 dilate
    assert bits[16, 8] and bits[16, 9] and bits[15, 9]


@pytest.mark.parametrize("dilate", [True, False])
def test_values_at_the_bf16_logit_threshold(dilate):
    """bf16 logits at the rounded logit threshold and one or two ulps on
    either side: the compare runs in f32 against the f32 threshold, as in
    the Pallas kernel."""
    tb = float(np.asarray(jnp.asarray(LOGIT_T, jnp.bfloat16).astype(jnp.float32)))
    steps = np.random.default_rng(5).integers(-2, 3, size=(2, 64, 128))
    x = (tb * (1.0 + steps / 128.0)).astype(np.float32)
    (ref_mask, ref_prob), (mask, prob) = _both(x, LOGIT_T, dilate, 2, True, True)
    np.testing.assert_array_equal(mask, ref_mask)
    np.testing.assert_array_equal(prob, ref_prob)
    assert 0 < np.unpackbits(mask, axis=1).mean() < 1


def test_pooled_prob_plain_is_the_plain_prob_half():
    x = torch.from_numpy(_maps(7, (1, 64, 128), True)).to(torch.bfloat16)
    assert torch.equal(pooled_prob_plain(x, 2, True), db_epilogue_plain(x, LOGIT_T)[1])


def test_wrapper_routes_cpu_tensors_to_plain_and_checks_inputs():
    x = torch.from_numpy(_maps(8, (1, 64, 128), True))
    before = (db_epilogue.launches, binarize_dilate_pack_rows_batch.launches)
    got = db_epilogue(x, LOGIT_T, True, 4, True)
    ref = db_epilogue_plain(x, LOGIT_T, True, 4, True)
    assert all(torch.equal(a, b) for a, b in zip(got, ref))
    assert (db_epilogue.launches, binarize_dilate_pack_rows_batch.launches) == before
    with pytest.raises(ValueError):
        db_epilogue(x, LOGIT_T, True, 3, True)  # the kernel pools by 1, 2 or 4
    with pytest.raises(ValueError):
        db_epilogue(torch.rand((1, 60, 128)))
    with pytest.raises(TypeError):
        db_epilogue(x.double())
    with pytest.raises(ValueError):
        db_epilogue(torch.empty((1, 64, 128), device="meta"))  # neither CPU nor CUDA


@pytest.mark.cuda
@pytest.mark.parametrize("pool", [1, 2, 4])
def test_cuda_kernel_equals_plain(pool):
    """The main shape, then the block-edge maps of ``chip_smoke.py``'s
    shapes (B = 1, 5, 16; H = 64, 1024; W = 128, 384, 1024) in every mode."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc (run chip_smoke.py on the card)")
    gen = torch.Generator(device="cuda").manual_seed(0)
    x = (torch.randn((4, 512, 384), generator=gen, device="cuda") * 3).to(torch.bfloat16)
    before = db_epilogue.launches
    got = db_epilogue(x, LOGIT_T, True, pool, True)
    torch.cuda.synchronize()
    assert db_epilogue.launches == before + 1
    ref = db_epilogue_plain(x, LOGIT_T, True, pool, True)
    assert torch.equal(got[0], ref[0]) and torch.equal(got[1], ref[1])
    for shape in ((1, 64, 128), (5, 1024, 384), (16, 64, 1024)):
        for logits in (True, False):
            edge = torch.from_numpy(_edge_map(shape, logits)).cuda()
            thresh = LOGIT_T if logits else 0.3
            for x in (edge.to(torch.bfloat16), edge):
                for dilate in (True, False):
                    got = db_epilogue(x, thresh, dilate, pool, logits)
                    torch.cuda.synchronize()
                    ref = db_epilogue_plain(x, thresh, dilate, pool, logits)
                    assert torch.equal(got[0], ref[0]) and torch.equal(got[1], ref[1]), (
                        shape, x.dtype, logits, dilate)
