"""retto_tpu_torch models against the Flax models on the same checkpoint.

Tolerances:
* float32: max |torch - flax| <= 1e-4 * max |flax| (summation order only);
* bfloat16: the port rounds where XLA:CPU rounds (tests/test_torch_bf16_sites.py),
  but the two frameworks' kernels sum in different orders, and a float32
  difference that crosses a bf16 rounding boundary moves a value by one
  bf16 step, which later layers carry on; the outputs are held to bounds
  measured with ~2x headroom: det logits 1.3% of max |logit| (measured
  0.64%), cls probabilities 1e-4 (4.2e-5), rec probabilities 1e-6.
  Since the CPU convs, dense and depthwise, sum in XLA:CPU's order
  (``models.common``), the measured values are 0.64%, 0 and 3.6e-7: the
  rec's LCNet features equal Flax's bits (its SE gates and final mean read
  the unrounded hard-swish product in XLA's windows with the 1/6 fused in,
  its SE and pointwise 1 x 1 convs sum in the HLO ``dot``s' orders,
  tools/cpu_parity_probe.py dw), and the mixer's float32 LayerNorm and
  softmax sums leave 3.6e-7 (4.7% before).

Each parity trap of the port is pinned by its own test: Flax SAME padding,
the tanh GELU, LayerNorm eps 1e-6 and the linear resize."""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F
from flax import linen as nn

from retto_tpu.models import build_cls as j_cls, build_det as j_det, build_rec as j_rec
from retto_tpu.models.dbnet import _depth_to_space as j_d2s, _space_to_depth as j_s2d
from retto_tpu.weights import load_params_meta as j_load
from retto_tpu_torch.models import build_cls, build_det, build_rec
from retto_tpu_torch.models.common import (
    ACTIVATIONS,
    Conv,
    LayerNorm,
    cast_compute,
    depth_to_space,
    space_to_depth,
)
from retto_tpu_torch.models.dbnet import upsample_linear
from retto_tpu_torch.models.registry import torch_dtype
from retto_tpu_torch.weights import load_flax_params, load_params_meta

TOL = {  # kind -> (float32 relative, bfloat16 relative)
    "det": (1e-4, 0.013),
    "cls": (1e-4, 1e-4),
    "rec": (1e-4, 1e-6),
}
SHAPES = {
    "det": [(1, 3, 128, 192), (2, 3, 64, 256)],
    "cls": [(2, 3, 48, 192), (1, 3, 48, 96)],
    "rec": [(2, 3, 48, 320), (1, 3, 48, 192)],
}
J_BUILD = {"det": j_det, "cls": j_cls, "rec": j_rec}
T_BUILD = {"det": build_det, "cls": build_cls, "rec": build_rec}


def _models(kind, dtype):
    tree, meta = j_load(f"trained_weights/{kind}.npz")
    kw = {k: tuple(v) if isinstance(v, list) else v for k, v in meta["overrides"].items()}
    extra = {"num_classes": 96} if kind == "rec" else {}
    jm = J_BUILD[kind]("bare", compute_dtype=dtype, **extra, **kw)
    flat, _ = load_params_meta(f"trained_weights/{kind}.npz")
    tm = load_flax_params(T_BUILD[kind]("bare", compute_dtype=dtype, **extra, **kw), flat)
    return jm, tree, cast_compute(tm, torch_dtype(dtype)).eval()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("kind", ["det", "cls", "rec"])
def test_forward_matches_flax(kind, dtype):
    jm, tree, tm = _models(kind, dtype)
    rng = np.random.default_rng(0)
    for shape in SHAPES[kind]:
        x = rng.uniform(-1, 1, shape).astype(np.float32)
        if kind == "det":  # the fused pipeline's call: NHWC in, raw logits out
            xn = jnp.asarray(np.transpose(x, (0, 2, 3, 1)))
            if dtype == "bfloat16":
                xn = xn.astype(jnp.bfloat16)
            fn = jax.jit(lambda p, v: jm.apply(p, v, nhwc=True, raw_logits=True))
            ref = np.asarray(fn(tree, xn).astype(jnp.float32))
            xt = torch.from_numpy(np.array(xn.astype(jnp.float32)))
            xt = xt.to(torch_dtype(dtype) or torch.float32)
            with torch.no_grad():
                got = tm(xt, nhwc=True, raw_logits=True).float().numpy()
        else:
            ref = np.asarray(jax.jit(jm.apply)(tree, jnp.asarray(x)))
            with torch.no_grad():
                got = tm(torch.from_numpy(x)).numpy()
        assert got.shape == ref.shape
        tol = TOL[kind][dtype == "bfloat16"]
        err = np.abs(got - ref).max() / np.abs(ref).max()
        assert err <= tol, (kind, dtype, shape, err)


def test_det_prob_path_uses_linear_resize():
    """DetModel's engine contract: stride-2 prob map upsampled with
    jax.image.resize(method="linear") (dbnet.py:356-360)."""
    jm, tree, tm = _models("det", "float32")
    x = np.random.default_rng(1).uniform(-1, 1, (1, 3, 64, 128)).astype(np.float32)
    ref = np.asarray(jax.jit(jm.apply)(tree, jnp.asarray(x)))
    with torch.no_grad():
        got = tm(torch.from_numpy(x)).numpy()
    assert got.shape == ref.shape == (1, 1, 64, 128)
    np.testing.assert_allclose(got, ref, atol=1e-5)


@pytest.mark.parametrize("factor", [2, 4])
def test_linear_resize_equals_jax_image_resize(factor):
    x = np.random.default_rng(2).normal(size=(2, 3, 5, 7)).astype(np.float32)
    ref = np.asarray(jax.image.resize(jnp.asarray(x), (2, 3, 5 * factor, 7 * factor),
                                      method="linear"))
    got = upsample_linear(torch.from_numpy(x), factor).numpy()
    np.testing.assert_allclose(got, ref, atol=1e-5)


@pytest.mark.parametrize("size", [(12, 16), (13, 15)])
@pytest.mark.parametrize("stride", [2, (2, 1)])
def test_same_padding_matches_flax(size, stride):
    """Flax SAME pads a stride-2 3x3 conv (0, 1) on an even extent, not
    (1, 1); the LCNet (2, 1) stride pads rows only that way."""
    rng = np.random.default_rng(3)
    x = rng.normal(size=(1, *size, 4)).astype(np.float32)
    mod = nn.Conv(5, (3, 3), strides=stride, padding="SAME", use_bias=False)
    v = mod.init(jax.random.PRNGKey(0), jnp.asarray(x))
    ref = np.asarray(mod.apply(v, jnp.asarray(x)))
    conv = Conv(4, 5, 3, stride, bias=False)
    conv.weight.data = torch.from_numpy(np.asarray(v["params"]["kernel"]).transpose(3, 2, 0, 1).copy())
    got = conv(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1).detach().numpy()
    np.testing.assert_allclose(got, ref, atol=1e-5)
    # and symmetric (1, 1) padding would not match on the even extent
    if size[0] % 2 == 0:
        sym = F.conv2d(torch.from_numpy(x).permute(0, 3, 1, 2), conv.weight, None,
                       conv.stride, 1).permute(0, 2, 3, 1).detach().numpy()
        assert np.abs(sym - ref).max() > 1e-3


def test_gelu_is_the_tanh_form():
    x = np.linspace(-6, 6, 1001).astype(np.float32)
    ref = np.asarray(nn.gelu(jnp.asarray(x)))
    got = ACTIVATIONS["gelu"](torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, ref, atol=1e-6)
    exact = F.gelu(torch.from_numpy(x)).numpy()
    assert np.abs(exact - ref).max() > 1e-4


def test_layernorm_eps_is_1e6():
    x = (np.random.default_rng(4).normal(size=(3, 16)) * 1e-3).astype(np.float32)
    mod = nn.LayerNorm()
    v = mod.init(jax.random.PRNGKey(0), jnp.asarray(x))
    ref = np.asarray(mod.apply(v, jnp.asarray(x)))
    got = LayerNorm(16)(torch.from_numpy(x)).detach().numpy()
    np.testing.assert_allclose(got, ref, atol=1e-4)
    wrong = F.layer_norm(torch.from_numpy(x), (16,), eps=1e-5).numpy()
    assert np.abs(wrong - ref).max() > 1e-2


@pytest.mark.parametrize("block", [4, 8])
def test_space_depth_channel_order(block):
    x = np.random.default_rng(5).normal(size=(2, 3, 16, 24)).astype(np.float32)
    ref = np.asarray(j_s2d(jnp.asarray(x.transpose(0, 2, 3, 1)), block)).transpose(0, 3, 1, 2)
    got = space_to_depth(torch.from_numpy(x), block)
    np.testing.assert_array_equal(got.numpy(), ref)
    back = np.asarray(j_d2s(jnp.asarray(ref.transpose(0, 2, 3, 1)), block))
    np.testing.assert_array_equal(depth_to_space(got, block).numpy(),
                                  back.transpose(0, 3, 1, 2))


def test_rec_mixer_from_flax_features_matches_flax():
    """The rec model's bf16 difference (TOL above) comes from the LCNet
    backbone's conv sums: fed the Flax backbone's own features, the port's
    SVTR mixer and CTC head give SVTRBlock_0 bit-exact and probabilities
    within 1e-6 of Flax's maximum (measured 3.6e-7; tools/cpu_parity_probe.py)."""
    jm, tree, tm = _models("rec", "bfloat16")
    x = np.random.default_rng(0).uniform(-1, 1, (2, 3, 48, 320)).astype(np.float32)
    ref, state = jax.jit(lambda p, v: jm.apply(p, v, capture_intermediates=True))(
        tree, jnp.asarray(x))
    ref, inter = np.asarray(ref), state["intermediates"]

    def flax_out(name):
        return np.array(inter[name]["__call__"][0].astype(jnp.float32))

    with torch.no_grad():
        feats = torch.from_numpy(flax_out("LCNetBackbone_0")).to(torch.bfloat16)
        seq32 = tm.Dense_0(feats, f32_out=True)
        seq, seq32 = tm.SVTRBlock_0(seq32.to(feats.dtype), seq32)
        np.testing.assert_array_equal(seq.float().numpy(), flax_out("SVTRBlock_0"))
        for name in tm.mixer[1:]:
            seq, seq32 = getattr(tm, name)(seq, seq32)
        logits = tm.Dense_1(tm.LayerNorm_0(seq32).to(seq.dtype), f32_out=True)
        got = torch.softmax(logits, dim=-1).numpy()
    assert np.abs(got - ref).max() <= 1e-6 * np.abs(ref).max()
