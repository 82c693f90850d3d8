"""The port's ONNX translator on graphs from an independent exporter: the
four PP-OCR-shaped torch models of tests/test_onnx_torch_export.py,
exported by torch's TorchScript ONNX exporter, run through the port's
``build_fn`` on the CPU and held to torch's own forward (rtol 1e-4, atol
1e-5, the JAX test's bounds) and to the JAX bridge on the same bytes
(within 1e-5 of max |JAX|: float32 sums in another order)."""

from __future__ import annotations

import jax
import numpy as np
import pytest
import torch

import test_onnx_torch_export as jx
from retto_tpu.weights.onnx_bridge import build_fn as j_build
from retto_tpu_torch.weights import build_fn


class _MaxPoolGemm(torch.nn.Module):
    """tests/test_onnx_torch_export.py::test_maxpool_and_gemm's model."""

    def __init__(self):
        super().__init__()
        self.c = torch.nn.Conv2d(3, 6, 3, padding=1)
        self.fc = torch.nn.Linear(6 * 4 * 4, 5)

    def forward(self, x):
        h = torch.max_pool2d(torch.relu(self.c(x)), 2, 2)
        return self.fc(h.flatten(1))


CASES = {  # name -> (model class, seed, input shape, output shape)
    "det_like": (jx._DetLike, 0, (2, 3, 32, 48), (2, 1, 32, 48)),
    "cls_like": (jx._ClsLike, 1, (3, 3, 48, 64), (3, 2)),
    "rec_like_attention": (jx._RecLike, 2, (2, 3, 16, 64), (2, 16, 11)),
    "maxpool_and_gemm": (_MaxPoolGemm, 3, (2, 3, 8, 8), (2, 5)),
}


@pytest.mark.parametrize("name", list(CASES))
def test_torch_exported_graph(name):
    make, seed, shape, out_shape = CASES[name]
    torch.manual_seed(seed)
    model = make().eval()
    x = np.random.default_rng(seed).normal(size=shape).astype(np.float32)
    data = jx._export(model, (torch.from_numpy(x),))
    fn, params = build_fn(data)
    with torch.no_grad():
        got = fn({k: torch.from_numpy(np.array(v)) for k, v in params.items()},
                 torch.from_numpy(x)).numpy()
        want = model(torch.from_numpy(x)).numpy()
    assert got.shape == out_shape
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)
    jfn, jparams = j_build(data)
    ref = np.asarray(jax.jit(jfn)(jparams, x))
    assert np.abs(got - ref).max() <= 1e-5 * np.abs(ref).max()
