"""Helper of tests/test_torch_train_step_*.py: the port's train step against
the JAX trainer on the CPU: the ``tiny`` rec, cls and det models in float32, from the same JAX initialisation, on
the same batch, with the tool's AdamW schedule (tools/train_synthetic.py:
``warmup_cosine_decay_schedule(0, lr, 1, 3)``, weight decay 1e-4).

Tolerances (float32; the two frameworks sum in different orders):
* the losses of steps 1-3 within 1e-4 relative;
* each first-step gradient within 1e-4 of that tensor's norm, the norm
  floored at 1% of the model's largest per-tensor gradient norm: some
  gradients are mathematically zero and only roundoff remains (a
  BatchNorm's shift that feeds a 1x1 conv and a train-mode BatchNorm, which
  takes the shift out again, or a BatchNorm scale at its initial zero
  shift before a ReLU and a train-mode BatchNorm; in the mbv3 cls their
  norms are 1e-8 to 1e-5 against 1e-2);
* the batch statistics after step 1 within 1e-5 absolute;
* after the three steps, each parameter tensor (in Flax's layout) within
  1e-2 in norm of the norm of JAX's change of that tensor (the change the
  two real updates made), for the tensors whose first-step gradient is
  above the floor: where a gradient is roundoff, Adam moves each weight
  by about the rate in the roundoff's direction, and the two trainers
  differ by as much (the largest figure, the det's ``ConvBNAct_3`` kernel
  before a train-mode BatchNorm, keeps some of that).  This holds the
  optimizer itself (rate, moments, weight decay) to optax.
The measured figures sit beside each kind in ``MEASURED``.

The first-step gradients are read from each optimizer's first moment: the
schedule's rate is 0 at the first update, so neither model moves, and
Adam's first moment is then ``(1 - 0.9) * g`` (optax ``mu``, torch
``exp_avg``), which saves a second JAX compile."""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import optax
import torch

from retto_tpu.models import build_cls as j_cls, build_det as j_det, build_rec as j_rec
from retto_tpu.train.losses import cls_loss as j_cls_loss, ctc_loss as j_ctc, db_loss as j_db
from retto_tpu.train.synth import db_ground_truth
from retto_tpu.train.trainer import init_train_state as j_init, make_train_step as j_step
from retto_tpu.weights.store import _flatten
from retto_tpu_torch.models import build_cls, build_det, build_rec
from retto_tpu_torch.train import (
    cls_loss,
    ctc_loss,
    db_loss,
    init_train_state,
    make_train_step,
    warmup_cosine_decay,
)
from retto_tpu_torch.weights import convert_flax_params, export_flax_params, load_flax_params

LR, STEPS = 1e-3, 3
# kind -> (largest loss difference, gradient difference / norm, batch stat
# difference, parameter difference / change norm) measured over the three steps
MEASURED = {"rec": (5.7e-6, 2.8e-6, 6.0e-8, 5.3e-5), "cls": (5.4e-7, 1.1e-5, 2.1e-6, 8.4e-4),
            "det": (8.9e-7, 3.2e-6, 3.6e-7, 5.3e-3)}


def _batch(kind: str, rng):
    if kind == "rec":
        x = rng.uniform(-1, 1, (4, 3, 48, 64)).astype(np.float32)
        labels = rng.integers(1, 12, (4, 4)).astype(np.int32)
        lengths = np.array([4, 2, 3, 1], np.int32)
        labels *= np.arange(4)[None, :] < lengths[:, None]  # zero padded
        return x, (labels, lengths)
    if kind == "cls":
        x = rng.uniform(-1, 1, (4, 3, 48, 96)).astype(np.float32)
        return x, (np.array([0, 1, 1, 0], np.int32),)
    x = rng.uniform(-1, 1, (2, 3, 64, 64)).astype(np.float32)
    gts = [db_ground_truth(np.array(b, np.float32), 32, 32) for b in
           ([[4, 4, 24, 12], [6, 18, 30, 26]], [[2, 8, 28, 20]])]
    return x, tuple(np.stack([g[i] for g in gts]) for i in range(4))


def _models(kind: str):
    if kind == "rec":
        return (j_rec("tiny", num_classes=12, compute_dtype=None),
                build_rec("tiny", num_classes=12, compute_dtype=None))
    if kind == "cls":
        return j_cls("tiny", compute_dtype=None), build_cls("tiny", compute_dtype=None)
    return j_det("tiny", compute_dtype=None), build_det("tiny", compute_dtype=None)


J_LOSS = {"rec": j_ctc, "cls": j_cls_loss, "det": j_db}
T_LOSS = {"rec": ctc_loss, "cls": cls_loss, "det": db_loss}


def run_train_steps(kind: str) -> list[float]:
    """Three steps of both trainers; asserts the tolerances above and
    returns the worst (loss, gradient, batch stat, parameter) differences."""
    rng = np.random.default_rng(0)
    x, rest = _batch(kind, rng)
    jm, tm = _models(kind)
    tx = optax.adamw(optax.warmup_cosine_decay_schedule(0.0, LR, 1, STEPS), weight_decay=1e-4)
    state = j_init(jm, tx, x, seed=0)
    load_flax_params(tm, _flatten({"params": state.params, "batch_stats": state.batch_stats}))
    if kind == "rec":
        def apply(variables, v, train=False, mutable=None):
            return jm.apply(variables, v, train=train, mutable=mutable, return_logits=True)
        jstep = j_step(apply, J_LOSS[kind], tx)
        forward = lambda m, v: m(v, return_logits=True)  # noqa: E731
    else:
        jstep = j_step(jm, J_LOSS[kind], tx)
        forward = None
    tstate = init_train_state(tm, warmup_cosine_decay(LR, 1, STEPS), device="cpu")
    tstep = make_train_step(tm, T_LOSS[kind], forward=forward)
    xt, rt = torch.from_numpy(x), [torch.from_numpy(r) for r in rest]
    start = _flatten({"params": state.params})
    worst = [0.0, 0.0, 0.0, 0.0]
    roundoff: set[str] = set()
    for i in range(STEPS):
        state, jloss = jstep(state, jnp.asarray(x), *map(jnp.asarray, rest))
        tstate, tloss = tstep(tstate, xt, *rt)
        rel = abs(float(tloss) - float(jloss)) / abs(float(jloss))
        worst[0] = max(worst[0], rel)
        assert rel <= 1e-4, (kind, i, float(tloss), float(jloss))
        if i:
            continue
        mu = _flatten({"params": state.opt_state[0].mu})
        jgrads = {k: v / 0.1 for k, v in convert_flax_params(mu).items()}
        floor = 1e-2 * max(float(np.linalg.norm(g.numpy())) for g in jgrads.values())
        # in Flax's layout, where each attention projection's bias is a
        # tensor of its own (the key bias's gradient is zero)
        roundoff = {k for k, v in mu.items() if float(np.linalg.norm(v)) / 0.1 < floor}
        opt = tstate.optimizer
        for name, p in tm.named_parameters():
            g, ref = p.grad.numpy(), jgrads[name].numpy()
            np.testing.assert_allclose(opt.state[p]["exp_avg"].numpy() / 0.1, g, rtol=1e-5,
                                       atol=1e-12)
            d = np.abs(g - ref).max() / max(float(np.linalg.norm(ref)), floor)
            worst[1] = max(worst[1], d)
            assert d <= 1e-4, (kind, name, d)
        stats = convert_flax_params(_flatten({"batch_stats": state.batch_stats}))
        for name, b in tm.named_buffers():
            d = float(np.abs(b.numpy() - stats[name].numpy()).max())
            worst[2] = max(worst[2], d)
            assert d <= 1e-5, (kind, name, d)
    assert tstate.step == int(state.step) == STEPS
    mine = export_flax_params(tm)
    for name, ref in _flatten({"params": state.params}).items():
        if name in roundoff:
            continue
        ref, p0 = np.asarray(ref), np.asarray(start[name])
        d = float(np.linalg.norm(mine[name] - ref) / np.linalg.norm(ref - p0))
        worst[3] = max(worst[3], d)
        assert d <= 1e-2, (kind, name, d)
    return worst
