"""Training checkpoint / resume (PyTorch).

Counterpart of ``retto_tpu/train/checkpoint.py:18-69`` (orbax there): saves
the whole ``TrainState`` (the model's parameters and batch stats, the
optimizer and schedule state, the step) with ``torch.save``.  Each save
writes a temporary file in the same directory and renames it over its
final name (``os.replace``), so a crash mid-save leaves every earlier
checkpoint whole; the newest ``keep`` are kept.
"""

from __future__ import annotations

import os
import re
from pathlib import Path

import torch

from .trainer import TrainState

__all__ = ["CheckpointManager"]

_NAME = re.compile(r"^ckpt_(\d+)\.pt$")


class CheckpointManager:
    def __init__(self, directory: str | Path, keep: int = 3):
        self._dir = Path(directory).absolute()
        self._dir.mkdir(parents=True, exist_ok=True)
        self._keep = keep

    def _path(self, step: int) -> Path:
        return self._dir / f"ckpt_{step:08d}.pt"

    def steps(self) -> list[int]:
        """The saved steps, oldest first."""
        return sorted(int(m.group(1)) for p in self._dir.iterdir()
                      if (m := _NAME.match(p.name)))

    def save(self, step: int, state: TrainState) -> None:
        payload = {
            "model": state.model.state_dict(),
            "optimizer": state.optimizer.state_dict(),
            "scheduler": None if state.scheduler is None else state.scheduler.state_dict(),
            "step": int(state.step),
        }
        tmp = self._dir / f".ckpt_{step:08d}.pt.tmp{os.getpid()}"
        torch.save(payload, tmp)
        os.replace(tmp, self._path(step))
        for old in self.steps()[:-self._keep]:
            self._path(old).unlink(missing_ok=True)

    def latest_step(self) -> int | None:
        steps = self.steps()
        return steps[-1] if steps else None

    def restore(self, template: TrainState, step: int | None = None) -> TrainState:
        """Load checkpoint ``step`` (default the newest) into ``template``,
        whose model and optimizer must have the saving run's structure, on
        the template model's device; returns the template."""
        step = self.latest_step() if step is None else step
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {self._dir}")
        device = next(template.model.parameters()).device
        payload = torch.load(self._path(step), map_location=device, weights_only=True)
        template.model.load_state_dict(payload["model"])
        template.optimizer.load_state_dict(payload["optimizer"])
        if template.scheduler is not None and payload["scheduler"] is not None:
            template.scheduler.load_state_dict(payload["scheduler"])
        template.step = payload["step"]
        return template

    def close(self) -> None:
        """Nothing to release: every save is complete when it returns."""
