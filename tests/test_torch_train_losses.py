"""retto_tpu_torch.train losses and schedule against retto_tpu.train on the
CPU: each loss and its gradient (``torch.autograd`` against ``jax.grad``) on
seeded inputs, and the learning-rate schedule against optax's.

Tolerances (float32): losses within 1e-5 relative (measured <= 3e-7), the
gradients within 1e-5 of the largest reference gradient (measured <= 2e-7),
the schedule within 1e-6 of the peak rate (optax computes it in float32)."""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from retto_tpu.train.losses import cls_loss as j_cls, ctc_loss as j_ctc, db_loss as j_db
from retto_tpu.train.synth import db_ground_truth
from retto_tpu_torch.train import cls_loss, ctc_loss, db_loss, warmup_cosine_decay


def _check(j_fn, t_fn, arrays, rest_j=(), rest_t=()):
    """Value and gradient w.r.t. ``arrays[0]`` (a dict of arrays for the det
    outputs) of both losses."""
    jval, jgrad = jax.value_and_grad(lambda a: j_fn(a, *rest_j))(arrays)
    if isinstance(arrays, dict):
        t_in = {k: torch.tensor(np.asarray(v), requires_grad=True) for k, v in arrays.items()}
        leaves = list(t_in.values())
        jleaves = [np.asarray(jgrad[k]) for k in t_in]
    else:
        t_in = torch.tensor(np.asarray(arrays), requires_grad=True)
        leaves, jleaves = [t_in], [np.asarray(jgrad)]
    tval = t_fn(t_in, *rest_t)
    tval.backward()
    assert abs(float(tval.detach()) - float(jval)) <= 1e-5 * abs(float(jval))
    scale = max(np.abs(g).max() for g in jleaves)
    for leaf, ref in zip(leaves, jleaves):
        assert np.abs(leaf.grad.numpy() - ref).max() <= 1e-5 * scale


@pytest.mark.parametrize("seed", [0, 1])
def test_ctc_loss_and_grad(seed):
    rng = np.random.default_rng(seed)
    logits = rng.normal(size=(3, 16, 9)).astype(np.float32) * 2
    lengths = np.array([5, 1, 3], np.int32)
    labels = rng.integers(1, 9, (3, 6)).astype(np.int32) * (np.arange(6)[None] < lengths[:, None])
    _check(j_ctc, ctc_loss, jnp.asarray(logits),
           (jnp.asarray(labels), jnp.asarray(lengths)),
           (torch.from_numpy(labels), torch.from_numpy(lengths)))


def test_ctc_loss_is_not_length_normalised():
    """optax's per-sequence NLL averaged over the batch, not torch's
    ``reduction="mean"`` (which also divides by each target length)."""
    rng = np.random.default_rng(5)
    logits = torch.from_numpy(rng.normal(size=(2, 10, 5)).astype(np.float32))
    labels = torch.tensor([[1, 2, 3], [4, 0, 0]], dtype=torch.int32)
    lengths = torch.tensor([3, 1], dtype=torch.int32)
    ref = float(j_ctc(jnp.asarray(logits.numpy()), jnp.asarray(labels.numpy()),
                      jnp.asarray(lengths.numpy())))
    torch_mean = float(torch.nn.functional.ctc_loss(
        torch.log_softmax(logits, -1).transpose(0, 1), labels.long(), torch.full((2,), 10),
        lengths.long(), reduction="mean"))
    assert abs(float(ctc_loss(logits, labels, lengths)) - ref) <= 1e-5 * ref
    assert abs(torch_mean - ref) > 0.1 * ref


def test_db_loss_and_grad():
    rng = np.random.default_rng(2)
    gts = [db_ground_truth(np.array(b, np.float32), 40, 48) for b in
           ([[4, 4, 30, 14], [6, 20, 40, 30]], [[2, 8, 44, 24]])]
    gt = [jnp.asarray(np.stack([g[i] for g in gts])) for i in range(4)]
    outs = {k: jnp.asarray(rng.uniform(0.02, 0.98, (2, 1, 40, 48)).astype(np.float32))
            for k in ("maps", "thresh", "binary")}
    _check(j_db, db_loss, outs, gt, [torch.from_numpy(np.array(g)) for g in gt])


def test_db_loss_ohem_keeps_the_hardest_negatives():
    """A single positive pixel: the mined negatives are the 259 largest
    negative losses (3 * 1 + 256)."""
    gs = np.zeros((1, 32, 32), np.float32)
    gs[0, 5, 5] = 1.0
    prob = np.random.default_rng(3).uniform(0.01, 0.99, (1, 1, 32, 32)).astype(np.float32)
    out = {"maps": torch.from_numpy(prob), "thresh": torch.zeros(1, 1, 32, 32),
           "binary": torch.from_numpy(prob)}
    ones, zeros = torch.ones(1, 32, 32), torch.zeros(1, 32, 32)
    got = float(db_loss(out, torch.from_numpy(gs), ones, zeros, zeros))
    ref = float(j_db({k: jnp.asarray(v.numpy()) for k, v in out.items()}, jnp.asarray(gs),
                     jnp.ones((1, 32, 32)), jnp.zeros((1, 32, 32)), jnp.zeros((1, 32, 32))))
    assert abs(got - ref) <= 1e-5 * ref


def test_cls_loss_and_grad():
    rng = np.random.default_rng(4)
    p = rng.uniform(0.01, 1, (6, 2)).astype(np.float32)
    p /= p.sum(1, keepdims=True)
    labels = np.array([0, 1, 1, 0, 1, 0], np.int32)
    _check(j_cls, cls_loss, jnp.asarray(p), (jnp.asarray(labels),), (torch.from_numpy(labels),))


@pytest.mark.parametrize("lr,warm,decay", [(1.2e-3, 200, 24000), (1e-3, 1, 3),
                                           (8e-4, 10, 11), (5e-4, 0, 50)])
def test_schedule_matches_optax(lr, warm, decay):
    ref = optax.warmup_cosine_decay_schedule(0.0, lr, warm, decay)
    got = warmup_cosine_decay(lr, warm, decay)
    for count in sorted({0, 1, 2, warm - 1, warm, warm + 1, decay // 2, decay - 1, decay,
                         decay + 5} - {-1}):
        assert abs(got(count) - float(ref(count))) <= 1e-6 * lr, count
