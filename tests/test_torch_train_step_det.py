"""The port's det train step against the JAX trainer: three float32 steps of
the ``tiny`` det model from the same JAX initialisation on the same batch
(tolerances and their measured values in tests/torch_train_parity.py)."""

from torch_train_parity import run_train_steps


def test_det_train_steps_match_jax():
    run_train_steps("det")
