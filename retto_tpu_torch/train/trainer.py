"""One-device training step (PyTorch).

Port of ``retto_tpu/train/trainer.py:28-134`` on one device.  A
``TrainState`` holds the model (whose parameters and BatchNorm running
statistics are the state's params and batch stats), the optimizer with its
learning-rate schedule, and the step count.  The optimizer is AdamW over
every parameter with optax's ``adamw`` defaults (betas 0.9/0.999, eps 1e-8,
the weight decay scaled by the scheduled rate, as torch scales it), and the
schedule is ``optax.warmup_cosine_decay_schedule(0, lr, warmup, decay)``
(:func:`warmup_cosine_decay`), whose ``decay_steps`` includes the warmup.

The JAX trainer's ``mesh=``, ``param_shardings`` and ``make_mesh`` (data-
and tensor-parallel training over a device mesh) wait for the port's
``torch.distributed`` work; this trainer runs on one device.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Callable

import torch
from torch import nn

__all__ = [
    "TrainState",
    "init_train_state",
    "make_train_step",
    "warmup_cosine_decay",
]


def warmup_cosine_decay(peak: float, warmup_steps: int, decay_steps: int
                        ) -> Callable[[int], float]:
    """``optax.warmup_cosine_decay_schedule(0, peak, warmup_steps,
    decay_steps)``: the rate at update ``count`` (0 for the first): linear
    from 0 to ``peak`` over ``warmup_steps``, then a cosine from ``peak``
    to 0 over the remaining ``decay_steps - warmup_steps``, 0 after."""
    span = decay_steps - warmup_steps

    def lr_at(count: int) -> float:
        if warmup_steps > 0 and count < warmup_steps:
            return peak * count / warmup_steps
        t = min(max(count - warmup_steps, 0), span) / span if span > 0 else 1.0
        return peak * 0.5 * (1.0 + math.cos(math.pi * t))

    return lr_at


@dataclass
class TrainState:
    """The model (params and batch stats), its optimizer and schedule, and
    the number of steps taken."""

    model: nn.Module
    optimizer: torch.optim.Optimizer
    scheduler: torch.optim.lr_scheduler.LRScheduler | None
    step: int = 0

    @property
    def params(self) -> dict[str, torch.Tensor]:
        return dict(self.model.named_parameters())

    @property
    def batch_stats(self) -> dict[str, torch.Tensor]:
        return dict(self.model.named_buffers())


def init_train_state(model: nn.Module, lr: float | Callable[[int], float],
                     weight_decay: float = 1e-4,
                     device: str | torch.device | None = None) -> TrainState:
    """Move ``model`` (float32 parameters, initialised by torch or loaded
    from a checkpoint) to ``device``, put it in training mode and give it
    AdamW over every parameter with a constant rate or a schedule ``count
    -> rate`` (:func:`warmup_cosine_decay`), as optax's ``adamw(schedule,
    weight_decay=...)``."""
    if device is not None:
        model.to(device)
    model.train()
    opt = torch.optim.AdamW(model.parameters(), lr=1.0, betas=(0.9, 0.999), eps=1e-8,
                            weight_decay=weight_decay)
    sched = lr if callable(lr) else (lambda count: lr)
    return TrainState(model, opt, torch.optim.lr_scheduler.LambdaLR(opt, sched), 0)


def make_train_step(model: nn.Module, loss_fn: Callable[..., torch.Tensor],
                    forward: Callable[[nn.Module, torch.Tensor], Any] | None = None):
    """A train step ``step(state, x, *rest) -> (state, loss)``: the model's
    training forward (``forward(model, x)``, default ``model(x)``), then
    ``loss_fn(output, *rest)``, its gradients, and one optimizer and
    schedule step.  The loss comes back as a detached tensor on the
    device."""
    fwd = forward or (lambda m, x: m(x))

    def step(state: TrainState, x: torch.Tensor, *rest) -> tuple[TrainState, torch.Tensor]:
        model.train()
        loss = loss_fn(fwd(model, x), *rest)
        state.optimizer.zero_grad(set_to_none=True)
        loss.backward()
        state.optimizer.step()
        if state.scheduler is not None:
            state.scheduler.step()
        state.step += 1
        return state, loss.detach()

    return step
