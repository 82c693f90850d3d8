"""The det prob map of the engine contract (``DetModel.forward``: the f32
sigmoid of the stride-2 logits, upsampled with ``jax.image.resize``
linear, retto_tpu/models/dbnet.py:221, :353-360) against the jitted Flax
model at bf16, as the staged det thresholds it at 0.3 and scores boxes
from it (retto_tpu/pipeline/stages.py:95-103).

The port computes the map in XLA:CPU's compiled steps (``models.dbnet``):
``1 / (1 + exp(-x))`` with XLA's own ``exp``, then two passes of two-tap
FMA chains.  Counts, stated because they are the bounds:

* ``exp_xla`` and ``sigmoid_xla``: 0 of 65,280 finite bf16 inputs differ
  from jitted JAX (``torch.exp`` differs on 494, the ``torch.sigmoid`` the
  port used before on 2,722 of page 0's 196,608 logits);
* ``upsample_linear``: 0 differing outputs at 32 x 32 and 64 x 64, 139 of 786,432 at
  512 x 384 (XLA's dot emitter picks its own order per shape; 278,326 for
  ``F.interpolate`` before), each one float32 step;
* the port's tail on Flax's own bf16 logits of fixture page 0: 133 of
  786,432 map values differ, 0 mask pixels;
* the whole bf16 model on fixture page 0: 149 of 786,432 map values
  differ in their bits (max 7.7e-6) and 0 mask pixels, since the CPU convs
  sum in XLA:CPU's order (``models.common``): 1 of 196,608 bf16 logits
  differs.  With oneDNN's order 628,019 values (max 0.0059), 66,687
  logits and 3 mask pixels differed."""

from __future__ import annotations

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from retto_tpu.config import SessionConfig as JConfig
from retto_tpu.image.io import _pil_resize
from retto_tpu.image.ops import normalize_det, pad_to
from retto_tpu.models import build_det as j_det
from retto_tpu.ops.db_post import binarize_dilate as j_binarize_dilate
from retto_tpu.pipeline.stages import _bucket_up, det_input_dims
from retto_tpu.weights import load_params_meta as j_load
from retto_tpu_torch.models import build_det
from retto_tpu_torch.models.common import cast_compute
from retto_tpu_torch.models.dbnet import exp_xla, sigmoid_xla, upsample_linear
from retto_tpu_torch.ops.db_post import binarize_dilate
from retto_tpu_torch.weights import load_flax_params, load_params_meta

ROOT = Path(__file__).resolve().parent.parent
BF16 = (np.arange(65536, dtype=np.uint32) << 16).view(np.float32)
FINITE = np.isfinite(BF16)


def _bits_differ(a: np.ndarray, b: np.ndarray) -> int:
    return int((np.asarray(a, np.float32).view(np.uint32)
                != np.asarray(b, np.float32).view(np.uint32)).sum())


def test_exp_xla_equals_jitted_exp_on_every_bf16_value():
    ref = np.asarray(jax.jit(jnp.exp)(jnp.asarray(BF16[FINITE])))
    assert _bits_differ(exp_xla(torch.from_numpy(BF16[FINITE])).numpy(), ref) == 0


def test_sigmoid_xla_equals_flax_sigmoid_on_every_bf16_value():
    x = jnp.asarray(BF16[FINITE]).astype(jnp.bfloat16)
    ref = np.asarray(jax.jit(lambda v: jax.nn.sigmoid(v.astype(jnp.float32)))(x))
    got = sigmoid_xla(torch.from_numpy(BF16[FINITE]).to(torch.bfloat16)).numpy()
    assert _bits_differ(got, ref) == 0


@pytest.mark.parametrize("hw,bound", [((64, 64), 0), ((32, 32), 0), ((512, 384), 139)])
def test_upsample_linear_against_jax_resize(hw, bound):
    x = np.random.default_rng(0).uniform(0, 1, (1, 1, *hw)).astype(np.float32)
    ref = np.asarray(jax.jit(lambda v: jax.image.resize(
        v, (1, 1, hw[0] * 2, hw[1] * 2), method="linear"))(jnp.asarray(x)))
    got = upsample_linear(torch.from_numpy(x), 2).numpy()
    assert _bits_differ(got, ref) <= bound
    np.testing.assert_allclose(got, ref, rtol=0, atol=1.2e-7)


@pytest.fixture(scope="module")
def page0():
    """(staged det input of fixture page 0, JAX model, params, port model)."""
    tree, meta = j_load(str(ROOT / "trained_weights" / "det.npz"))
    kw = {k: tuple(v) if isinstance(v, list) else v for k, v in meta["overrides"].items()}
    jm = j_det("bare", compute_dtype="bfloat16", **kw)
    flat, _ = load_params_meta(str(ROOT / "trained_weights" / "det.npz"))
    tm = load_flax_params(build_det("bare", compute_dtype="bfloat16", **kw), flat)
    tm = cast_compute(tm, torch.bfloat16).eval()
    cfg = JConfig()
    img = np.repeat(np.load(ROOT / "retto_tpu_torch" / "testdata" / "smoke_pages.npz")
                    ["pages"][0][..., None], 3, axis=2)
    rh, rw = det_input_dims(*img.shape[:2], cfg.det.limit_type, cfg.det.limit_side_len,
                            cfg.buckets.det_max_side)
    x = normalize_det(jnp.asarray(_pil_resize(img, rw, rh)), cfg.det.mean, cfg.det.std,
                      cfg.det.scale)
    bh = _bucket_up(rh, cfg.buckets.det_pad_to, cfg.buckets.det_max_side)
    bw = _bucket_up(rw, cfg.buckets.det_pad_to, cfg.buckets.det_max_side)
    return pad_to(x, bh, bw, mode="edge"), (rh, rw), jm, tree, tm


def _masks(ref: np.ndarray, got: np.ndarray, rh: int, rw: int) -> int:
    jmask = np.asarray(j_binarize_dilate(jnp.asarray(ref)[:, :, :rh, :rw], 0.3, True))
    tmask = binarize_dilate(torch.from_numpy(got)[:, :, :rh, :rw], 0.3, True).numpy()
    return int((jmask != tmask).sum())


def test_prob_map_tail_on_flax_logits(page0):
    x, (rh, rw), jm, tree, _ = page0
    ref = np.asarray(jax.jit(jm.apply)(tree, x))
    logits = jax.jit(lambda p, v: jm.apply(p, v, raw_logits=True))(tree, x)
    lt = torch.from_numpy(np.array(logits.astype(jnp.float32))).to(torch.bfloat16)
    got = upsample_linear(sigmoid_xla(lt), 2).numpy()
    assert got.shape == ref.shape == (1, 1, 1024, 768)
    assert _bits_differ(got, ref) <= 133
    assert _masks(ref, got, rh, rw) == 0


def test_bf16_prob_map_and_mask_against_flax(page0):
    x, (rh, rw), jm, tree, tm = page0
    ref = np.asarray(jax.jit(jm.apply)(tree, x))
    with torch.inference_mode():
        got = tm(torch.from_numpy(np.array(x))).numpy()
    assert got.shape == ref.shape
    assert _bits_differ(got, ref) <= 149
    assert np.abs(got - ref).max() <= 7.7e-6
    assert _masks(ref, got, rh, rw) == 0
