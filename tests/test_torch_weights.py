"""retto_tpu_torch weights: Flax checkpoint -> PyTorch state dict.

The shipped det, cls and rec checkpoints must load with no missing and no
unused keys, and each layout rule of ``weights/convert.py`` is held to the
Flax module it converts."""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as nn

from retto_tpu.models.registry import MODEL_PRESETS as JAX_PRESETS
from retto_tpu_torch.models import MODEL_PRESETS, build_cls, build_det, build_rec
from retto_tpu_torch.models.common import Conv, Dense
from retto_tpu_torch.models.svtr import MultiHeadDotProductAttention
from retto_tpu_torch.weights import convert_flax_params, load_flax_params, load_params_meta

BUILDERS = {"det": build_det, "cls": build_cls, "rec": build_rec}


def _arch(meta):
    return {k: tuple(v) if isinstance(v, list) else v for k, v in meta["overrides"].items()}


@pytest.mark.parametrize("kind", ["det", "cls", "rec"])
def test_checkpoint_loads_with_no_missing_or_unused_keys(kind):
    flat, meta = load_params_meta(f"trained_weights/{kind}.npz")
    extra = {"num_classes": 96} if kind == "rec" else {}
    model = BUILDERS[kind]("bare", **extra, **_arch(meta))
    sd = convert_flax_params(flat)
    assert set(sd) == set(model.state_dict())
    load_flax_params(model, flat)
    for k, v in sd.items():
        assert torch.equal(model.state_dict()[k], v), k


def test_missing_or_unused_keys_raise():
    flat, meta = load_params_meta("trained_weights/cls.npz")
    dropped = {k: v for k, v in flat.items() if "ConvBNAct_3::Conv_0" not in k}
    with pytest.raises(KeyError, match="missing keys"):
        load_flax_params(build_cls("bare", **_arch(meta)), dropped)
    extra = dict(flat, **{"params::Dense_9::bias": np.zeros(2, np.float32)})
    with pytest.raises(KeyError, match="Dense_9"):
        load_flax_params(build_cls("bare", **_arch(meta)), extra)


def test_presets_equal_the_jax_dict():
    assert MODEL_PRESETS == JAX_PRESETS


def _flat_vars(variables):
    out = {}

    def walk(tree, prefix):
        for k, v in tree.items():
            key = f"{prefix}::{k}" if prefix else k
            if isinstance(v, dict) or hasattr(v, "items"):
                walk(v, key)
            else:
                out[key] = np.asarray(v)

    walk(variables, "")
    return out


@pytest.mark.parametrize("groups,stride", [(1, 1), (1, 2), (6, 1)])
def test_conv_layout_hwio_and_depthwise(groups, stride):
    rng = np.random.default_rng(0)
    x = rng.normal(size=(2, 10, 12, 6)).astype(np.float32)  # NHWC
    mod = nn.Conv(6, (3, 3), strides=stride, padding="SAME", feature_group_count=groups)
    variables = mod.init(jax.random.PRNGKey(1), jnp.asarray(x))
    ref = np.asarray(mod.apply(variables, jnp.asarray(x)))
    conv = Conv(6, 6, 3, stride, groups=groups)
    sd = convert_flax_params(_flat_vars({"params": variables["params"]}))
    conv.load_state_dict(sd)
    got = conv(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    np.testing.assert_allclose(got.detach().numpy(), ref, rtol=1e-5, atol=1e-5)


def test_dense_and_attention_layouts():
    rng = np.random.default_rng(1)
    x = rng.normal(size=(2, 7, 24)).astype(np.float32)
    dense = nn.Dense(5)
    dv = dense.init(jax.random.PRNGKey(0), jnp.asarray(x))
    lin = Dense(24, 5)
    lin.load_state_dict(convert_flax_params(_flat_vars({"params": dv["params"]})))
    np.testing.assert_allclose(lin(torch.from_numpy(x)).detach().numpy(),
                               np.asarray(dense.apply(dv, jnp.asarray(x))),
                               rtol=1e-5, atol=1e-5)

    class Wrap(nn.Module):
        @nn.compact
        def __call__(self, y):
            return nn.MultiHeadDotProductAttention(num_heads=4)(y, y)

    mha = Wrap()
    mv = mha.init(jax.random.PRNGKey(2), jnp.asarray(x))
    ref = np.asarray(mha.apply(mv, jnp.asarray(x)))
    sd = convert_flax_params(_flat_vars({"params": mv["params"]}))
    att = torch.nn.Module()
    att.MultiHeadDotProductAttention_0 = MultiHeadDotProductAttention(24, 4)
    att.load_state_dict(sd)
    got = att.MultiHeadDotProductAttention_0(torch.from_numpy(x)).detach().numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5)
