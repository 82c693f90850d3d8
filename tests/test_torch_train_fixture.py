"""The train phase of chip_smoke.py on the CPU: four steps under the tool's
AdamW schedule for three from each shipped mobile checkpoint (bf16 compute,
float32 master weights) on the fixture batches of
``retto_tpu_torch/testdata/smoke_train.npz``, against the JAX trainer's
losses and parameter change stored there (tools/make_torch_smoke_fixture.py
--train).  The first and the fourth update run at rate 0, so losses 3 and
4 read the two real updates.

Tolerances, relative to JAX's (loss 1; losses 2-4; the L2 norm of the
parameters' change over the four steps), about twice the CPU figures
measured for this slice in ``MEASURED``:
* rec 5e-4; 3e-3; 6e-4.  The rec lines are turned 180 degrees, so the
  shipped rec's loss is O(100) and its gradients are the data's, not the
  bf16 roundoff's (on its own upright lines the loss is 8e-4).
* cls 5e-4; 6e-4; 1.2e-3.
* det 3e-3; 0.01; 1.5e-3.
chip_smoke.py holds the card to ``TRAIN_LOSS_TOL`` by the same rule."""

from __future__ import annotations

import numpy as np
import pytest
import torch

import chip_smoke

TOL = {"rec": (5e-4, 3e-3, 6e-4), "cls": (5e-4, 6e-4, 1.2e-3), "det": (3e-3, 0.01, 1.5e-3)}
MEASURED = {"rec": (2.5e-4, 1.3e-3, 2.7e-4), "cls": (1.1e-4, 2.8e-4, 5.3e-4),
            "det": (1.2e-3, 4.6e-3, 6.1e-4)}


@pytest.fixture
def two_threads():
    """Two intra-op threads for these full-width bf16 steps: beside the
    suite's other workers, torch's default of one thread per core
    oversubscribes the CPU many times over."""
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


@pytest.mark.parametrize("kind", ["rec", "cls", "det"])
def test_fixture_train_steps_match_jax(kind, two_threads):
    fx = np.load(chip_smoke.ROOT / "retto_tpu_torch" / "testdata" / "smoke_train.npz")
    losses, delta, model, state, _ = chip_smoke.train_fixture_losses(fx, kind, "cpu")
    ref = fx[f"{kind}_losses"].astype(float)
    ref_delta = float(fx[f"{kind}_delta_norm"])
    rel = [abs(a - b) / abs(b) for a, b in zip(losses, ref)]
    assert state.step == 4 and np.isfinite(losses).all()
    assert rel[0] <= TOL[kind][0] and max(rel[1:]) <= TOL[kind][1], (losses, ref.tolist())
    assert abs(delta - ref_delta) / ref_delta <= TOL[kind][2], (delta, ref_delta)
    # the card's bounds are no tighter than the CPU's
    assert all(c >= t for c, t in zip(chip_smoke.TRAIN_LOSS_TOL[kind], TOL[kind]))
