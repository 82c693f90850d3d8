"""The model families this slice ports, against Flax on the CPU: the train
mode of ``BatchNorm``, the ``tpu`` det (``TpuBackbone`` -> ``DBFPN`` ->
``DBHead``) and the ``mobilenetv3`` det backbone, and the ``mbv3`` cls, at
the ``tiny`` preset, with Flax's own initialisation (batch statistics
perturbed) carried over by ``load_flax_params``.

Tolerances, relative to the largest reference value:
* float32: 1e-5 for outputs, train-mode maps and updated batch statistics
  (summation order only), 1e-4 for the binary map, ``sigmoid(50 (P - T))``,
  which scales a difference of P or T by up to 12.5;
* bfloat16, inference: 0.02 (one bf16 step of a value moves later layers);
* bfloat16, train mode: 0.05 for the prob and threshold maps, the cls
  probabilities and the updated batch statistics (the batch statistics of
  a bf16 activation are summed in other orders, and a different bf16
  rounding of the normalised value follows); the binary map, which scales
  a difference of P or T by up to 12.5, is held to be ``sigmoid(50 (P -
  T))`` of the port's own maps and within 0.25 of Flax's.
Measured values are in ``MEASURED``."""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as nn

from retto_tpu.models import build_cls as j_cls, build_det as j_det
from retto_tpu.weights.store import _flatten, _unflatten
from retto_tpu_torch.models import build_cls, build_det
from retto_tpu_torch.models.common import BatchNorm, make_divisible
from retto_tpu_torch.weights import convert_flax_params, load_flax_params

CASES = {  # name -> (JAX builder, port builder, input shape, overrides)
    "det_tpu": (j_det, build_det, (2, 3, 64, 64), {}),
    "det_mobilenetv3": (j_det, build_det, (2, 3, 64, 64), {"backbone": "mobilenetv3"}),
    "cls_mbv3": (j_cls, build_cls, (2, 3, 48, 96), {}),
}
TOL = {"float32": 1e-5, "bfloat16": 0.02}
TRAIN_BF16 = 0.05
BINARY_BF16 = 0.25
# (case, dtype) -> largest relative difference: inference output; train
# prob map (cls: probabilities), threshold map, binary map; batch stats
MEASURED = {
    ("det_tpu", "float32"): (1.2e-7, 1.8e-6, 1.7e-6, 1.2e-5, 9.5e-7),
    ("det_tpu", "bfloat16"): (7.3e-5, 5.0e-3, 8.1e-3, 0.071, 1.5e-3),
    ("det_mobilenetv3", "float32"): (3.0e-7, 4.7e-6, 4.9e-6, 4.4e-5, 6.9e-6),
    ("det_mobilenetv3", "bfloat16"): (1.9e-3, 0.014, 0.025, 0.19, 0.021),
    ("cls_mbv3", "float32"): (4.9e-8, 7.5e-7, None, None, 1.3e-6),
    ("cls_mbv3", "bfloat16"): (3.8e-4, 8.0e-3, None, None, 0.014),
}


def _pair(name: str, dtype: str, rng):
    jb, tb, shape, kw = CASES[name]
    jm = jb("tiny", compute_dtype=dtype, **kw)
    x = rng.uniform(-1, 1, shape).astype(np.float32)
    v = jax.jit(lambda r, v: jm.init(r, v, train=True))(jax.random.PRNGKey(0), jnp.asarray(x))
    flat = {k: a + rng.uniform(0.05, 0.3, a.shape).astype(np.float32)
            if k.startswith("batch_stats") else a for k, a in _flatten(v).items()}
    tm = load_flax_params(tb("tiny", compute_dtype=dtype, **kw), flat)
    return jm, _unflatten(flat), tm, x


def _rel(got, ref) -> float:
    return float(np.abs(np.asarray(got, np.float32) - np.asarray(ref, np.float32)).max()
                 / max(np.abs(np.asarray(ref, np.float32)).max(), 1e-12))


def test_make_divisible_matches_jax():
    from retto_tpu.models.common import make_divisible as j_make_divisible

    for v in (3.2, 5.6, 8.0, 12.5, 16 * 0.35, 576 * 0.35, 960 * 0.5, 100.0):
        assert make_divisible(v) == j_make_divisible(v)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_batchnorm_train_mode_matches_flax(dtype):
    rng = np.random.default_rng(0)
    x = (rng.normal(size=(4, 7, 9, 6)) * 3 + 1.5).astype(np.float32)
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    xb = jnp.asarray(x).astype(jdt)
    mod = nn.BatchNorm(use_running_average=False, momentum=0.9, epsilon=1e-5, dtype=jdt)
    v = mod.init(jax.random.PRNGKey(0), xb)
    stats = {"mean": rng.normal(size=6).astype(np.float32),
             "var": rng.uniform(0.5, 2, 6).astype(np.float32)}
    params = {"scale": rng.uniform(0.5, 1.5, 6).astype(np.float32),
              "bias": rng.normal(size=6).astype(np.float32)}
    ref, upd = mod.apply({"params": params, "batch_stats": stats}, xb, mutable=["batch_stats"])
    bn = BatchNorm(6)
    with torch.no_grad():
        bn.weight.copy_(torch.from_numpy(params["scale"]))
        bn.bias.copy_(torch.from_numpy(params["bias"]))
        bn.running_mean.copy_(torch.from_numpy(stats["mean"]))
        bn.running_var.copy_(torch.from_numpy(stats["var"]))
    bn.train()
    xt = torch.from_numpy(np.asarray(xb.astype(jnp.float32))).permute(0, 3, 1, 2)
    got = bn(xt.to(getattr(torch, dtype))).float().permute(0, 2, 3, 1).detach().numpy()
    ref = np.asarray(ref.astype(jnp.float32))
    step = 2.0 ** -7 if dtype == "bfloat16" else 1e-5
    assert np.abs(got - ref).max() <= step * np.abs(ref).max()
    np.testing.assert_allclose(bn.running_mean.numpy(), upd["batch_stats"]["mean"], rtol=1e-6,
                               atol=1e-6)
    # the biased variance of the batch, not F.batch_norm's unbiased one
    np.testing.assert_allclose(bn.running_var.numpy(), upd["batch_stats"]["var"], rtol=1e-5)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", list(CASES))
def test_family_inference_matches_flax(name, dtype):
    rng = np.random.default_rng(1)
    jm, tree, tm, x = _pair(name, dtype, rng)
    ref = np.asarray(jax.jit(jm.apply)(tree, jnp.asarray(x)))
    with torch.no_grad():
        got = tm(torch.from_numpy(x)).float().numpy()
    assert got.shape == ref.shape
    assert _rel(got, ref) <= TOL[dtype], _rel(got, ref)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", list(CASES))
def test_family_train_mode_matches_flax(name, dtype):
    rng = np.random.default_rng(2)
    jm, tree, tm, x = _pair(name, dtype, rng)
    ref, upd = jax.jit(lambda v, x: jm.apply(v, x, train=True, mutable=["batch_stats"]))(
        tree, jnp.asarray(x))
    tm.train()
    got = tm(torch.from_numpy(x))
    tol = TOL["float32"] if dtype == "float32" else TRAIN_BF16
    if name.startswith("det"):
        assert set(got) == set(ref) == {"maps", "thresh", "binary"}
        for k in got:
            assert got[k].shape == ref[k].shape
            err = _rel(got[k].detach().numpy(), ref[k])
            if k == "binary":
                tol = tol * 10 if dtype == "float32" else BINARY_BF16
            assert err <= tol, (k, err)
        torch.testing.assert_close(got["binary"], torch.sigmoid(50.0 * (got["maps"] - got["thresh"])),
                                   rtol=0, atol=0)
    else:
        assert _rel(got.detach().numpy(), ref) <= tol
    stats = convert_flax_params(_flatten({"batch_stats": upd["batch_stats"]}))
    worst = max(_rel(b.numpy(), stats[n].numpy()) for n, b in tm.named_buffers())
    assert worst <= (1e-5 if dtype == "float32" else TRAIN_BF16), worst
