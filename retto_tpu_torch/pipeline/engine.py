"""Model execution engines (PyTorch).

Port of ``retto_tpu/pipeline/engine.py:32-152``: the slot of the
reference's worker layer (worker.rs:69-98), three tensor entry points with
the reference's signatures:

    det: f32 [N, 3, H, W] -> f32 [N, 1, H, W]
    cls: f32 [N, 3, H, W] -> f32 [N, 2]
    rec: f32 [N, 3, H, W] -> f32 [N, T, C]

``TorchEngine`` runs the port's ``nn.Module`` forwards eagerly, one call
per input shape; ``compiled_shapes()`` counts the distinct shapes each
stage has seen, the analog of ``JaxEngine``'s jit-cache sizes.  With
``mesh=`` (``parallel.mesh``) each forward's batch is split over the mesh's
'data' devices, each device runs its own replica of the model, and the
outputs come back concatenated in row order (engine.py:38-42, 82-89).
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
from ..parallel.mesh import mesh_devices, replicate_module

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
    and ``lock``, the owning session's dispatch lock, which covers every
    model call of the session, this engine's and its ``DevicePipeline``'s
    alike.

    On CUDA the engine computes in full float32 where the models compute in
    float32: TF32 is off for matmuls and convs, the BatchNorm convs
    included (``models.common.full_float32``; each conv sets cuDNN's
    process-wide TF32 flag under ``models.common``'s one lock, so another
    session's TF32 convs in another thread cannot reach it).  A TF32 sum moves a det box
    by a pixel now and then, and COMPAT's carried ``max_wh_ratio`` turns
    one wider crop into another width for every crop of its chunk
    (PERF.md, Findings).  Outputs stay on the device.

    ``mesh=``: the models are on the mesh's first 'data' device (the
    engine's ``device``); every other device of the mesh gets a replica.
    A batch splits over the 'data' devices as evenly as it can, and a
    device whose part is empty runs nothing: the staged stages send one
    det image per call, which the JAX engine's ``device_put`` refuses for
    a data size above 1.  Every row's forward is its own, so the result
    is the mesh-free one up to the sum orders of the smaller batches."""

    def __init__(
        self,
        det_model: torch.nn.Module | None = None,
        cls_model: torch.nn.Module | None = None,
        rec_model: torch.nn.Module | None = None,
        device: str | torch.device | None = None,
        lock: threading.RLock | None = None,
        mesh=None,
    ):
        self._devices = mesh_devices(mesh, device)
        self.device = self._devices[0]
        if any(d.type == "cuda" for d in self._devices):
            # float32 matmuls stay float32 (device_pipeline.py); the convs
            # set cuDNN's flag under models.common's lock
            torch.backends.cuda.matmul.allow_tf32 = False
        self.lock = lock if lock is not None else threading.RLock()
        self._models = {k: m for k, m in (("det", det_model), ("cls", cls_model),
                                          ("rec", rec_model)) if m is not None}
        # per stage, one model per 'data' device (shared where a device repeats)
        self._replicas: dict[str, list[torch.nn.Module]] = {}
        for k, m in self._models.items():
            by_dev = {self.device: m}
            for d in self._devices:
                if d not in by_dev:
                    by_dev[d] = replicate_module(m, d)
            self._replicas[k] = [by_dev[d] for d in self._devices]
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
            if len(self._devices) == 1:
                return model(x)
            outs = [rep(part.to(d)).to(self.device)
                    for rep, d, part in zip(self._replicas[name], self._devices,
                                            x.tensor_split(len(self._devices)))
                    if part.shape[0]]
            return torch.cat(outs)

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
