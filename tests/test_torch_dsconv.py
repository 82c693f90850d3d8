"""The port's depthwise convs against Flax bit for bit on the CPU, bf16:
XLA:CPU sums a depthwise conv's taps in a fixed tree
(``models.common._DW_TREES``), which the port's CPU path follows.

* ``DSConv`` without its SE gate (LCNet blocks 0, 2, 4, 6) at the mobile
  rec's LCNet shapes: exact.
* The depthwise ``ConvBNAct`` alone, 3x3 and 5x5 (MobileNetV3), at strides
  1, 2 and (2, 1): exact.
The SE gate's 1 x 1 convs on the pooled map are ``dot``s in XLA:CPU,
summed in an order that depends on the shapes (ROADMAP Queue 3 item 3);
they are not held here."""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from retto_tpu.models.common import ConvBNAct as JConvBNAct
from retto_tpu.models.svtr import DSConv as JDSConv
from retto_tpu.weights.store import _flatten
from retto_tpu_torch.models.common import ConvBNAct, cast_compute
from retto_tpu_torch.models.svtr import DSConv
from retto_tpu_torch.weights import load_flax_params


def _bf16(rng, shape, scale=1.0):
    return np.asarray(jnp.asarray(rng.normal(size=shape) * scale).astype(jnp.bfloat16)
                      .astype(jnp.float32))


def _perturbed(variables, rng):
    flat = _flatten(variables)
    return {k: (a + rng.uniform(0.1, 0.5, a.shape).astype(np.float32)
                if k.startswith("batch_stats") else a) for k, a in flat.items()}


def _run(jm, tm, x, rng):
    v = jm.init(jax.random.PRNGKey(0), jnp.asarray(x))
    flat = _perturbed(v, rng)
    from retto_tpu.weights.store import _unflatten

    ref = np.asarray(jax.jit(jm.apply)(_unflatten(flat), jnp.asarray(x).astype(jnp.bfloat16))
                     .astype(jnp.float32))
    cast_compute(load_flax_params(tm, flat), torch.bfloat16)
    xt = torch.from_numpy(x).permute(0, 3, 1, 2).to(torch.bfloat16)
    with torch.no_grad():
        got = tm(xt).float().permute(0, 2, 3, 1).numpy()
    return got, ref


# the mobile rec's LCNet on a [2, 3, 48, 320] batch: (input NHWC, out, stride)
LCNET = [((2, 24, 160, 32), 64, 2), ((2, 12, 80, 64), 128, 2), ((2, 6, 40, 128), 256, (2, 1)),
         ((2, 3, 40, 256), 512, 1)]


@pytest.mark.parametrize("shape,out_ch,stride", LCNET)
def test_dsconv_without_se_is_bit_exact(shape, out_ch, stride):
    rng = np.random.default_rng(shape[-1])
    x = _bf16(rng, shape)
    got, ref = _run(JDSConv(out_ch, 3, stride, use_se=False, dtype=jnp.bfloat16),
                    DSConv(shape[-1], out_ch, stride, use_se=False), x, rng)
    assert (got != ref).sum() == 0


@pytest.mark.parametrize("k,stride,shape", [(3, 1, (2, 12, 20, 48)), (3, 2, (2, 13, 17, 24)),
                                            (5, 1, (2, 9, 11, 40)), (5, 2, (3, 16, 16, 72)),
                                            (3, (2, 1), (2, 6, 40, 128))])
def test_depthwise_convbnact_is_bit_exact(k, stride, shape):
    rng = np.random.default_rng(k * 100 + shape[-1])
    c = shape[-1]
    x = _bf16(rng, shape)
    got, ref = _run(JConvBNAct(c, k, stride, groups=c, act="hardswish", dtype=jnp.bfloat16),
                    ConvBNAct(c, c, k, stride, groups=c, act="hardswish"), x, rng)
    assert (got != ref).sum() == 0
