"""Model execution engines (PyTorch).

Port of ``retto_tpu/pipeline/engine.py:32-152``: the slot of the
reference's worker layer (worker.rs:69-98), three tensor entry points with
the reference's signatures:

    det: f32 [N, 3, H, W] -> f32 [N, 1, H, W]
    cls: f32 [N, 3, H, W] -> f32 [N, 2]
    rec: f32 [N, 3, H, W] -> f32 [N, T, C]

``TorchEngine`` runs the port's ``nn.Module`` forwards eagerly, one call
per input shape; ``compiled_shapes()`` counts the distinct shapes each
stage has seen, the analog of ``JaxEngine``'s jit-cache sizes.
``FakeEngine`` gives deterministic closed-form outputs, so pipeline logic
is testable without weights.
"""

from __future__ import annotations

import threading
from typing import Any, Callable, Protocol

import numpy as np
import torch

from ..device import resolve_device
from ..errors import RettoEngineError
from ..models.common import full_float32

__all__ = ["Engine", "TorchEngine", "FakeEngine"]


class Engine(Protocol):
    def det(self, x: Any) -> torch.Tensor: ...
    def cls(self, x: Any) -> torch.Tensor: ...
    def rec(self, x: Any) -> torch.Tensor: ...


def _host(x: Any) -> np.ndarray:
    """A tensor or array-like as a host numpy array."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


class TorchEngine:
    """Eager PyTorch forwards for the three stages (engine.py:45-102).

    The models are the port's ``nn.Module``s, already on ``device`` in eval
    mode; any of them may be None, and a stage without a model raises
    ``RettoEngineError``.  Every forward runs under ``torch.inference_mode()``
    and ``lock``, the owning session's dispatch lock: the fused pipeline's
    forwards flip cuDNN's process-wide TF32 flag around their BatchNorm
    convs (``models.common._tf32_convs``), so one lock covers every model
    call of the session, this engine's and its ``DevicePipeline``'s alike.

    On CUDA the engine computes in full float32 where the models compute in
    float32: TF32 is off for matmuls and convs, the BatchNorm convs
    included (``models.common.full_float32``).  A TF32 sum moves a det box
    by a pixel now and then, and COMPAT's carried ``max_wh_ratio`` turns
    one wider crop into another width for every crop of its chunk
    (PERF.md, Findings).  Outputs stay on the device."""

    def __init__(
        self,
        det_model: torch.nn.Module | None = None,
        cls_model: torch.nn.Module | None = None,
        rec_model: torch.nn.Module | None = None,
        device: str | torch.device = "cuda",
        lock: threading.RLock | None = None,
    ):
        self.device = resolve_device(device)
        if self.device.type == "cuda":
            # float32 matmuls and convs stay float32 (device_pipeline.py)
            torch.backends.cuda.matmul.allow_tf32 = False
            torch.backends.cudnn.allow_tf32 = False
        self.lock = lock if lock is not None else threading.RLock()
        self._models = {k: m for k, m in (("det", det_model), ("cls", cls_model),
                                          ("rec", rec_model)) if m is not None}
        self._shapes: dict[str, set[tuple[int, ...]]] = {k: set() for k in self._models}

    def _run(self, name: str, x) -> torch.Tensor:
        model = self._models.get(name)
        if model is None:
            raise RettoEngineError(
                f"engine has no '{name}' model (models are optional per "
                f"stage; configure one to run this stage)"
            )
        x = torch.as_tensor(x, dtype=torch.float32, device=self.device)
        with self.lock, torch.inference_mode(), full_float32():
            self._shapes[name].add(tuple(x.shape))
            return model(x)

    def det(self, x) -> torch.Tensor:
        return self._run("det", x)

    def cls(self, x) -> torch.Tensor:
        return self._run("cls", x)

    def rec(self, x) -> torch.Tensor:
        return self._run("rec", x)

    def modules(self) -> dict[str, torch.nn.Module]:
        """The stage models, for a fused ``DevicePipeline`` over the same
        weights."""
        return dict(self._models)

    def compiled_shapes(self) -> dict[str, int]:
        """Distinct input shapes per stage (engine.py:100-102: the jit
        cache's size there; here the shapes an eager forward has met)."""
        return {k: len(v) for k, v in self._shapes.items()}


class FakeEngine:
    """Deterministic engine for pipeline tests (engine.py:105-152).

    * det: prob map = mean input channel mapped from [-1, 1] to [0, 1]
      (a bright box on a black background detects as a region)
    * cls: constant (p0, p1) per call, configurable
    * rec: a fixed index sequence per row, configurable

    Outputs are float32 tensors on ``device``; ``calls`` records (stage,
    input shape) per call."""

    def __init__(
        self,
        cls_probs: tuple[float, float] = (0.95, 0.05),
        rec_indices: tuple[int, ...] = (1, 1, 0, 2),
        rec_classes: int = 96,
        det_fn: Callable[[np.ndarray], np.ndarray] | None = None,
        device: str | torch.device = "cuda",
    ):
        self.device = resolve_device(device)
        self.cls_probs = cls_probs
        self.rec_indices = rec_indices
        self.rec_classes = rec_classes
        self.det_fn = det_fn
        self.calls: list[tuple[str, tuple]] = []

    def _out(self, arr: np.ndarray) -> torch.Tensor:
        return torch.as_tensor(np.asarray(arr, np.float32), device=self.device)

    def det(self, x) -> torch.Tensor:
        x = _host(x)
        self.calls.append(("det", x.shape))
        if self.det_fn is not None:
            return self._out(self.det_fn(x))
        return self._out((x.mean(axis=1, keepdims=True) + 1.0) / 2.0)

    def cls(self, x) -> torch.Tensor:
        x = _host(x)
        self.calls.append(("cls", x.shape))
        return self._out(np.tile(np.asarray(self.cls_probs, np.float32), (x.shape[0], 1)))

    def rec(self, x) -> torch.Tensor:
        x = _host(x)
        self.calls.append(("rec", x.shape))
        n, _, _, w = x.shape
        t = max(w // 8, len(self.rec_indices))
        probs = np.full((n, t, self.rec_classes), 1e-6, np.float32)
        probs[:, :, 0] = 0.9
        for j, idx in enumerate(self.rec_indices):
            probs[:, j, 0] = 1e-6
            probs[:, j, idx] = 0.9
        return self._out(probs)
