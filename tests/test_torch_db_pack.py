"""retto_tpu_torch.ops.db_pack: the plain PyTorch version of the det
epilogue kernel is bit-equal to the Pallas kernels it replaces
(``binarize_dilate_pack_rows_batch`` and ``binarize_dilate_pack_rows``,
run in interpret mode on the CPU, as tests/test_pallas_pack.py runs them).

The CUDA kernel itself runs only on a card: its test is marked ``cuda``
and skips here; ``chip_smoke.py`` holds it to the plain version on the
H100."""

from __future__ import annotations

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from retto_tpu.ops.pallas.db_pack import (
    binarize_dilate_pack_rows as j_rows,
    binarize_dilate_pack_rows_batch as j_batch,
)
from retto_tpu_torch.ops.db_pack import (
    binarize_dilate_pack_rows,
    binarize_dilate_pack_rows_batch,
    binarize_dilate_pack_rows_batch_plain,
    tile_edge_pixels,
    unpack_rows,
)

LOGIT_T = math.log(0.3 / 0.7)
# maps with one pixel above the threshold at each edge of every tile the
# CUDA kernel stages (``tile_edge_pixels``): B = 1, 5, 2; H = 64, 1024;
# W = 128, 384, 1024
EDGE_SHAPES = ((1, 64, 128), (5, 64, 384), (1, 1024, 1024))


def _edge_map(shape, seed: int = 0) -> np.ndarray:
    """Probabilities in [0, 0.28] with one pixel at 0.9 at each edge of
    every tile the CUDA kernel stages."""
    x = 0.28 * np.random.default_rng(seed).uniform(size=shape)
    x[tile_edge_pixels(shape)] = 0.9
    return x.astype(np.float32)


def _both(x: np.ndarray, thresh: float, dilate: bool, bf16: bool = False):
    jx = jnp.asarray(x)
    tx = torch.from_numpy(x)
    if bf16:
        jx = jx.astype(jnp.bfloat16)
        tx = tx.to(torch.bfloat16)
    ref = np.asarray(j_batch(jx, thresh, dilate, interpret=True))
    got = binarize_dilate_pack_rows_batch_plain(tx, thresh, dilate).numpy()
    return ref, got


@pytest.mark.parametrize("dilate", [True, False])
@pytest.mark.parametrize("seed", [0, 1])
def test_plain_equals_pallas_random(seed, dilate):
    x = np.random.default_rng(seed).uniform(0, 1, (2, 128, 256)).astype(np.float32)
    ref, got = _both(x, 0.3, dilate)
    assert got.dtype == np.uint8 and got.shape == (2, 16, 256)
    np.testing.assert_array_equal(got, ref)


def test_plain_equals_pallas_one_map():
    """The one-map entry point (the TPU's ``_kernel``) is the B = 1 case."""
    x = np.random.default_rng(2).uniform(0, 1, (1, 1, 64, 128)).astype(np.float32)
    ref = np.asarray(j_rows(jnp.asarray(x), 0.3, True, interpret=True))
    got = binarize_dilate_pack_rows(torch.from_numpy(x), 0.3, True).numpy()
    np.testing.assert_array_equal(got, ref)


def test_tile_boundary_halo():
    x = np.zeros((2, 128, 256), np.float32)
    x[0, 63, 100] = 0.9  # last row of a 64-row tile
    x[1, 7, 0] = 0.9  # last row of a packed group, column 0
    x[1, 127, 255] = 0.9  # bottom-right corner
    ref, got = _both(x, 0.3, True)
    np.testing.assert_array_equal(got, ref)
    m = unpack_rows(got[0], 128, 256)
    assert m[63, 100] and m[64, 100] and m[64, 101] and m[63, 101]
    assert not m[62, 99] and m.sum() == 4


@pytest.mark.parametrize("bf16", [True, False], ids=["bf16", "f32"])
@pytest.mark.parametrize("shape", EDGE_SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_tile_boundary_halo_block_edges(shape, bf16):
    """A pixel at each edge of every tile the CUDA kernel stages (its last
    row and column, their corner, its first row and column, the last row of
    its first packed group), dilated and not, against the Pallas kernel."""
    x = _edge_map(shape)
    for dilate in (True, False):
        ref, got = _both(x, 0.3, dilate, bf16)
        np.testing.assert_array_equal(got, ref)
        _, ys, xs = tile_edge_pixels(shape)
        _, h, w = shape
        want = ((1 + (ys + 1 < h)) * (1 + (xs + 1 < w))).sum() if dilate else len(ys)
        assert np.unpackbits(got, axis=1).sum() == want


@pytest.mark.parametrize("dilate", [True, False])
def test_bf16_at_the_logit_threshold(dilate):
    rng = np.random.default_rng(3)
    x = (rng.normal(size=(3, 64, 384)) * 2).astype(np.float32)
    ref, got = _both(x, LOGIT_T, dilate, bf16=True)
    np.testing.assert_array_equal(got, ref)


def test_values_exactly_at_the_threshold():
    t32 = float(np.float32(0.3))
    x = np.where(np.random.default_rng(4).uniform(size=(1, 64, 128)) > 0.5, t32,
                 0.0).astype(np.float32)
    ref, got = _both(x, 0.3, True)
    np.testing.assert_array_equal(got, ref)
    assert not got.any()  # equal is not above


def test_wrapper_routes_cpu_tensors_to_plain_and_checks_inputs():
    x = torch.rand((1, 64, 128))
    before = binarize_dilate_pack_rows_batch.launches
    assert torch.equal(binarize_dilate_pack_rows_batch(x, 0.3, True),
                       binarize_dilate_pack_rows_batch_plain(x, 0.3, True))
    assert binarize_dilate_pack_rows_batch.launches == before  # no kernel launched
    with pytest.raises(ValueError):
        binarize_dilate_pack_rows_batch(torch.rand((1, 60, 128)))
    with pytest.raises(ValueError):
        binarize_dilate_pack_rows_batch(torch.rand((1, 64, 100)))
    with pytest.raises(TypeError):
        binarize_dilate_pack_rows_batch(torch.rand((1, 64, 128)).double())


@pytest.mark.cuda
def test_cuda_kernel_equals_plain():
    """The main shape, then the block-edge maps of ``chip_smoke.py``'s
    shapes (B = 1, 5, 16; H = 64, 1024; W = 128, 384, 1024), bf16 and f32,
    dilated and not."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc (run chip_smoke.py on the card)")
    gen = torch.Generator(device="cuda").manual_seed(0)
    x = (torch.randn((4, 512, 384), generator=gen, device="cuda") * 3).to(torch.bfloat16)
    before = binarize_dilate_pack_rows_batch.launches
    got = binarize_dilate_pack_rows_batch(x, LOGIT_T, True)
    torch.cuda.synchronize()
    assert binarize_dilate_pack_rows_batch.launches == before + 1
    assert torch.equal(got, binarize_dilate_pack_rows_batch_plain(x, LOGIT_T, True))
    for shape in ((1, 64, 128), (5, 1024, 384), (16, 64, 1024)):
        edge = torch.from_numpy(_edge_map(shape)).cuda()
        for x in (edge.to(torch.bfloat16), edge):
            for dilate in (True, False):
                got = binarize_dilate_pack_rows_batch(x, 0.3, dilate)
                torch.cuda.synchronize()
                assert torch.equal(got, binarize_dilate_pack_rows_batch_plain(x, 0.3, dilate)), (
                    shape, x.dtype, dilate)
