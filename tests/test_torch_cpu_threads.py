"""The port's CPU forwards do not depend on torch's intra-op thread count.

The mobile rec, the 6,625-class ``rec_big`` rec and the cls from the
shipped checkpoints, and the tiny det from a seeded random init, each give
equal bits at 1, 2 and 8 threads.  Their Dense products (a Flax ``Dense``
is an HLO ``dot``) sum in XLA:CPU's order on the CPU
(``models.common.linear_nobias``), where oneDNN's blocked sums follow the
thread count; that order is held here to ``jax.jit(a @ w)`` on bf16
operands bit for bit at the rec's and the cls's shapes from 1 row up, on
random operands and on operands that reveal the summation tree (a +-2^40
pair among ones in each row: the sum counts the ones outside the pair's
smallest common subtree), and the attention's two batched products
likewise against flax's einsums.

Reference gap, recorded in ROADMAP Queue 3: XLA:CPU's own float32 convs
can sum otherwise on one core than on several (Eigen's single-threaded
blocking); the port keeps the multi-threaded order at every thread count,
the one the tests' JAX runs use on a host of several cores."""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from retto_tpu_torch.models import build_cls, build_det, build_rec
from retto_tpu_torch.models.common import cast_compute, linear_nobias
from retto_tpu_torch.models.registry import torch_dtype
from retto_tpu_torch.weights import load_flax_params, load_params_meta

THREADS = (1, 2, 8)


def _shipped(kind: str, path: str, **extra):
    flat, meta = load_params_meta(path)
    kw = {k: tuple(v) if isinstance(v, list) else v for k, v in meta["overrides"].items()}
    build = {"det": build_det, "cls": build_cls, "rec": build_rec}[kind]
    dtype = meta.get("compute_dtype", "bfloat16")
    model = load_flax_params(build(meta.get("preset", "mobile"), compute_dtype=dtype,
                                   **extra, **kw), flat)
    return cast_compute(model, torch_dtype(dtype)).eval()


def _tiny_det():
    torch.manual_seed(0)
    return cast_compute(build_det("tiny"), torch.bfloat16).eval()


MODELS = {
    "rec": (lambda: _shipped("rec", "trained_weights/rec.npz", num_classes=96),
            (4, 3, 48, 320)),
    "rec_big": (lambda: _shipped("rec", "trained_weights/rec_big.npz", num_classes=6625),
                (4, 3, 48, 320)),
    "cls": (lambda: _shipped("cls", "trained_weights/cls.npz"), (4, 3, 48, 192)),
    "det_tiny": (_tiny_det, (2, 3, 128, 192)),
}


@pytest.mark.parametrize("kind", MODELS)
def test_forward_bits_independent_of_threads(kind):
    make, shape = MODELS[kind]
    model = make()
    x = torch.from_numpy(np.random.default_rng(0).uniform(-1, 1, shape).astype(np.float32))
    before = torch.get_num_threads()
    outs = {}
    try:
        for n in THREADS:
            torch.set_num_threads(n)
            with torch.no_grad():
                outs[n] = model(x).float().numpy()
    finally:
        torch.set_num_threads(before)
    assert np.isfinite(outs[1]).all()
    for n in THREADS[1:]:
        np.testing.assert_array_equal(outs[n], outs[1], err_msg=f"{kind} at {n} threads")


# (K, N) of the mobile rec's Dense products: the backbone -> mixer projection,
# the attention's q/k/v and output, the MLP, both heads; and the cls's head
DENSE = [(512, 120), (120, 360), (120, 120), (120, 240), (240, 120), (120, 96),
         (120, 6625), (256, 2)]
BIG = 2.0 ** 40


def _cancelling(rng, m: int, k: int) -> np.ndarray:
    """[m, k] ones with a +-2^40 pair at random terms of each row: times a
    [k, n] of ones, each sum counts the ones outside the pair's smallest
    common subtree, which differs between summation orders."""
    a = np.ones((m, k), np.float32)
    for r in range(m):
        i, j = rng.choice(k, 2, replace=False)
        a[r, i], a[r, j] = BIG, -BIG
    return a


@pytest.mark.parametrize("m", [1, 2, 8, 16, 24, 32, 40, 48, 50, 52, 64, 80, 160, 512])
def test_dense_sums_in_xla_order(m):
    """``linear_nobias`` equals XLA:CPU's bf16 ``dot`` bit for bit at 1 and
    8 threads, from one row (a cls crop) to the rec's row counts (1, 2, 4
    and 8 lines of 320 and 512 pixels), on random operands and on
    cancelling ones."""
    rng = np.random.default_rng(m)
    dot = jax.jit(lambda a, w: a @ w)
    before = torch.get_num_threads()
    try:
        for k, n in DENSE:
            for label, a, w in (
                    ("random", rng.standard_normal((m, k)).astype(np.float32),
                     (rng.standard_normal((k, n)) * 0.1).astype(np.float32)),
                    ("cancelling", _cancelling(rng, m, k), np.ones((k, n), np.float32))):
                a = jnp.asarray(a).astype(jnp.bfloat16)
                w = jnp.asarray(w).astype(jnp.bfloat16)
                want = np.asarray(dot(a, w).astype(jnp.float32))
                at = torch.from_numpy(np.asarray(a.astype(jnp.float32))).to(torch.bfloat16)
                wt = torch.from_numpy(np.asarray(w.astype(jnp.float32)).T.copy()
                                      ).to(torch.bfloat16)
                for threads in (1, 8):
                    torch.set_num_threads(threads)
                    got = linear_nobias(at, wt).float().numpy()
                    np.testing.assert_array_equal(got, want,
                                                  err_msg=f"{label} {(m, k, n)} {threads}")
    finally:
        torch.set_num_threads(before)


@pytest.mark.parametrize("lines,t", [(1, 40), (2, 40), (8, 40), (2, 64), (8, 96), (2, 128)])
def test_attention_products_in_xla_order(lines, t):
    """The mobile rec's attention products (8 heads of 15 over ``t`` steps)
    through ``models.common.xla_batched_dot`` as ``svtr.attend`` calls it
    equal flax's einsums under ``jax.jit`` bit for bit on cancelling
    operands: the query-key product over the head width and the value
    product over the keys (stored minor-contracted from 2 lines up)."""
    from retto_tpu_torch.models.common import xla_batched_dot

    h, dh = 8, 15
    rng = np.random.default_rng(t * 10 + lines)
    qk = jax.jit(lambda q, k: jnp.einsum("...qhd,...khd->...hqk", q, k))
    pv = jax.jit(lambda w, v: jnp.einsum("...hqk,...khd->...qhd", w, v))
    ones = np.ones((lines, t, h, dh), np.float32)
    q = _cancelling(rng, lines * t * h, dh).reshape(lines, t, h, dh)
    want = np.asarray(qk(jnp.asarray(q, jnp.bfloat16), jnp.asarray(ones, jnp.bfloat16))
                      .astype(jnp.float32))
    qt = torch.from_numpy(q).to(torch.bfloat16)
    kt = torch.from_numpy(ones).to(torch.bfloat16)
    got = xla_batched_dot(qt.permute(0, 2, 1, 3), kt.permute(0, 2, 3, 1))
    np.testing.assert_array_equal(got.to(torch.bfloat16).float().numpy(), want)
    p = _cancelling(rng, lines * h * t, t).reshape(lines, h, t, t)
    want = np.asarray(pv(jnp.asarray(p, jnp.bfloat16), jnp.asarray(ones, jnp.bfloat16))
                      .astype(jnp.float32))
    pt = torch.from_numpy(p).to(torch.bfloat16)
    got = xla_batched_dot(kt.permute(0, 2, 3, 1), pt.transpose(-1, -2), rhs_t=lines > 1)
    np.testing.assert_array_equal(got.to(torch.bfloat16).float().permute(0, 3, 1, 2).numpy(),
                                  want)
