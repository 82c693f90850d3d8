"""The port's CPU arithmetic in XLA:CPU's steps (``native/conv_xla.cpp``,
used by ``models.common`` on CPU tensors) against XLA:CPU itself:

* ``rsqrt_xla_native``: bit-equal to jitted ``jax.lax.rsqrt`` on 400,000
  float32 values over 60 decades and on zero, negative, infinite,
  subnormal and NaN inputs (``torch.rsqrt`` differs from XLA on 27.7% of
  float32 inputs, ROADMAP Queue 3);
* ``conv_xla_native``: bit-equal to a jitted float32
  ``lax.conv_general_dilated`` (NHWC x HWIO) at the shapes of the mobile
  det's BatchNorm convs on a 1024 x 768 page (contraction lengths 1,152,
  1,728, 2,304 and 3,456 = 9 x cin), stride 1 and 2, SAME padding;
  ``torch.conv2d`` differs on most outputs.  XLA's blocking also depends
  on the output sizes (at couts of 32-48 it cuts the contraction
  otherwise), so these are the shapes that the tests hold exact; the port
  applies the order to every dense conv on the CPU."""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from retto_tpu_torch import native
from retto_tpu_torch.models.common import _same_pads, _xla_kc

RNG = np.random.default_rng(0)


def _bf16(a: np.ndarray) -> np.ndarray:
    return np.asarray(jnp.asarray(a).astype(jnp.bfloat16).astype(jnp.float32))


def test_rsqrt_xla_equals_jitted_rsqrt():
    x = np.concatenate([RNG.uniform(1e-6, 10, 200_000), 10 ** RNG.uniform(-30, 30, 200_000),
                        [0.0, -0.0, -1.0, np.inf, -np.inf, 1e-40, np.nan]]).astype(np.float32)
    ref = np.asarray(jax.jit(jax.lax.rsqrt)(jnp.asarray(x)))
    got = native.rsqrt_xla_native(x)
    same = (got.view(np.uint32) == ref.view(np.uint32)) | (np.isnan(got) & np.isnan(ref))
    assert int((~same).sum()) == 0


@pytest.mark.parametrize("cin,cout,hw,stride", [
    (192, 128, (128, 96), 1),  # the stem after the 8x space-to-depth
    (128, 256, (128, 96), 2),
    (256, 384, (64, 48), 2),
    (384, 384, (32, 24), 1),
    (384, 128, (128, 96), 1),  # the head's ConvBNAct
], ids=["stem", "stage2_down", "stage3_down", "stage3_res", "head"])
def test_conv_xla_equals_jitted_conv(cin, cout, hw, stride):
    assert _xla_kc(9 * cin) == (320 if cin == 384 else 288)
    rng = np.random.default_rng(cin + cout)
    x = _bf16(rng.normal(size=(1, *hw, cin)).astype(np.float32))
    w = _bf16(rng.normal(size=(3, 3, cin, cout)).astype(np.float32) * 0.05)
    pads = (_same_pads(hw[0], 3, stride), _same_pads(hw[1], 3, stride))
    ref = np.asarray(jax.jit(lambda a, b: jax.lax.conv_general_dilated(
        a, b, (stride, stride), pads, dimension_numbers=("NHWC", "HWIO", "NHWC")))(x, w))
    got = native.conv_xla_native(x, w, (stride, stride), (pads[0][0], pads[1][0]),
                                 ref.shape[1:3], _xla_kc(9 * cin), 4)
    np.testing.assert_array_equal(got.view(np.uint32), ref.view(np.uint32))
    xt = F.pad(torch.from_numpy(x).permute(0, 3, 1, 2), (*pads[1], *pads[0]))
    onednn = F.conv2d(xt, torch.from_numpy(w).permute(3, 2, 0, 1), stride=stride)
    assert int((onednn.permute(0, 2, 3, 1).numpy() != ref).sum()) > 0
