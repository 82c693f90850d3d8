"""Device mesh and placement helpers (PyTorch).

Port of ``retto_tpu/parallel/mesh.py``.  JAX drives every chip of a host
from one process; the port keeps that level as :class:`Mesh`, a 2-D array
of ``torch.device`` with axes ``("data", "model")`` that one process
drives (``DevicePipeline``, ``RettoSession`` and ``TorchEngine`` take it as
``mesh=``).  Across processes the port uses ``torch.distributed``: a
``torch.distributed.device_mesh.DeviceMesh`` with the same axis names
(``parallel.distributed.global_mesh``) drives the trainer, one rank per
card.  Inference handed a ``DeviceMesh`` runs on this process's own device
(:func:`local_mesh`), as each JAX host feeds its own chips.

A mesh may name one device more than once: that is the analog of the JAX
tests' virtual CPU devices (``[torch.device("cpu")] * 8`` in the CPU tests,
``[cuda:0, cuda:0]`` on one card).  Placement is explicit, where JAX's is
declared: :func:`data_sharding` and :func:`replicate` return a
:class:`Placement` whose ``put`` splits or copies a tensor onto the mesh's
'data' devices, and the 'model' axis replicates, as the JAX pipeline and
engine leave it.
"""

from __future__ import annotations

import copy
from dataclasses import dataclass

import numpy as np
import torch

from ..device import resolve_device

__all__ = [
    "Mesh",
    "PartitionSpec",
    "P",
    "Placement",
    "make_mesh",
    "shard_batch",
    "data_sharding",
    "replicate",
    "local_mesh",
    "mesh_devices",
    "replicate_module",
]

AXES = ("data", "model")


class PartitionSpec(tuple):
    """``jax.sharding.PartitionSpec``: one mesh axis name (or None) per
    dimension, ``P()`` for replicated."""

    def __new__(cls, *axes: str | None):
        return super().__new__(cls, axes)

    def __repr__(self) -> str:
        return f"P{tuple.__repr__(self)}"


P = PartitionSpec


class Mesh:
    """A ``("data", "model")`` grid of devices that one process drives."""

    axis_names = AXES

    def __init__(self, devices: np.ndarray):
        devices = np.asarray(devices, dtype=object)
        if devices.ndim != 2 or devices.size == 0:
            raise ValueError(f"a mesh is a non-empty 2-D device grid, got {devices.shape}")
        self.devices = devices

    @property
    def shape(self) -> dict[str, int]:
        return dict(zip(AXES, self.devices.shape))

    @property
    def size(self) -> int:
        return int(self.devices.size)

    @property
    def data_devices(self) -> list[torch.device]:
        """One device per 'data' index: the first of its 'model' row (the
        'model' axis replicates in inference)."""
        return [torch.device(d) for d in self.devices[:, 0]]

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, {[str(d) for d in self.devices.reshape(-1)]})"


@dataclass(frozen=True)
class Placement:
    """``NamedSharding(mesh, spec)`` with the two specs the pipeline and
    the engine use: ``P("data")`` splits dim 0 over the 'data' devices,
    ``P()`` copies onto each of them."""

    mesh: Mesh
    spec: PartitionSpec

    @property
    def devices(self) -> list[torch.device]:
        return self.mesh.data_devices

    def put(self, x: torch.Tensor) -> list[torch.Tensor]:
        """One tensor per 'data' device: its rows of ``x`` (``P("data")``)
        or all of ``x`` (``P()``)."""
        devs = self.devices
        if not self.spec:
            return [x.to(d) for d in devs]
        if self.spec != P("data"):
            raise ValueError(f"unsupported placement spec {self.spec!r}")
        n = len(devs)
        if x.shape[0] % n:
            raise ValueError(
                f"batch of {x.shape[0]} rows does not split over {n} 'data' devices "
                f"(pads are the caller's job)"
            )
        return [part.to(d) for part, d in zip(x.chunk(n), devs)]


def _cuda_devices() -> list[torch.device]:
    n = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if n == 0:
        raise RuntimeError(
            "retto_tpu_torch.parallel.make_mesh: no CUDA device; pass devices= "
            "(for example [torch.device('cpu')] * 8) to build a mesh elsewhere"
        )
    return [torch.device("cuda", i) for i in range(n)]


def make_mesh(n_devices: int | None = None, model_parallel: int = 1,
              devices=None) -> Mesh:
    """``("data", "model")`` mesh over the first ``n_devices`` of
    ``devices`` (default: every CUDA device of this process; raises when
    there is none).  A device may appear more than once."""
    devices = [torch.device(d) for d in (devices if devices is not None else _cuda_devices())]
    if n_devices is not None:
        devices = devices[:n_devices]
    n = len(devices)
    if n == 0 or n % model_parallel:
        raise ValueError(f"{n} devices not divisible by model_parallel={model_parallel}")
    arr = np.empty(n, dtype=object)
    arr[:] = devices
    return Mesh(arr.reshape(n // model_parallel, model_parallel))


def data_sharding(mesh: Mesh, axis: str = "data") -> Placement:
    """Batch-dim placement over ``axis``."""
    return Placement(mesh, P(axis))


def replicate(mesh: Mesh) -> Placement:
    return Placement(mesh, P())


def shard_batch(mesh: Mesh, x: torch.Tensor) -> list[torch.Tensor]:
    """``x`` split along dim 0 into ``mesh.shape["data"]`` equal parts, each
    on its 'data' device; a batch the data size does not divide raises (pads
    are the caller's job: batch buckets are multiples of the data size)."""
    return data_sharding(mesh).put(x)


def local_mesh(mesh) -> Mesh:
    """The mesh one process drives: a :class:`Mesh` as it is; for a
    ``torch.distributed`` ``DeviceMesh``, this rank's own device (one rank
    per card), a 1 x 1 mesh."""
    if isinstance(mesh, Mesh):
        return mesh
    device_type = getattr(mesh, "device_type", None)
    if device_type is None:
        raise TypeError(f"expected a Mesh or a DeviceMesh, got {type(mesh).__name__}")
    dev = (torch.device("cuda", torch.cuda.current_device()) if device_type == "cuda"
           else torch.device(device_type))
    return make_mesh(devices=[dev])


def mesh_devices(mesh, device: str | torch.device | None) -> list[torch.device]:
    """The 'data' devices an engine or pipeline runs on: ``[device]``
    (default ``"cuda"``, which raises without a card) without a mesh, else
    the mesh's (its local part for a ``DeviceMesh``).  A ``device`` that is
    not the mesh's first 'data' device raises."""
    if mesh is None:
        return [resolve_device(device)]
    devs = data_sharding(local_mesh(mesh)).devices
    for d in set(devs):
        resolve_device(d)
    if device is not None:
        want = resolve_device(device)
        if want.type == "cuda" and want.index is None:
            want = torch.device("cuda", torch.cuda.current_device())
        if want != devs[0]:
            raise ValueError(f"device={device} is not the mesh's first 'data' device {devs[0]}")
    return devs


def replicate_module(module: torch.nn.Module, device: torch.device) -> torch.nn.Module:
    """A copy of ``module`` on ``device`` (a translated ONNX graph also
    puts its folded constants there, so a capture uploads nothing)."""
    rep = copy.deepcopy(module).to(device)
    prepare = getattr(getattr(rep, "fn", None), "prepare", None)
    if prepare is not None:
        prepare(device)
    return rep
