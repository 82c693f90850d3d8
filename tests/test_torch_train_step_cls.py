"""The port's cls train step against the JAX trainer: three float32 steps of
the ``tiny`` cls model from the same JAX initialisation on the same batch
(tolerances and their measured values in tests/torch_train_parity.py)."""

from torch_train_parity import run_train_steps


def test_cls_train_steps_match_jax():
    run_train_steps("cls")
