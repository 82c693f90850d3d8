"""Multi-process support: ``torch.distributed`` init and per-process input
dispatch.

Port of ``retto_tpu/parallel/distributed.py``.  Where JAX forms one runtime
over every host with ``jax.distributed``, the port forms one
``torch.distributed`` process group over every rank, one rank per card
(``torchrun --nproc_per_node=N`` on each host): NCCL for CUDA devices,
gloo only when the caller names the CPU.  A process without a coordinator
(no arguments, no torchrun environment) is the single-process no-op, so
every code path runs without a second process.

Typical multi-process driver::

    from retto_tpu_torch.parallel import distributed as dist

    dist.initialize()                  # torchrun's environment
    mesh = dist.global_mesh()          # ('data', 'model') over every rank
    mine = dist.host_shard(files)      # this rank's slice of the corpus
    session = RettoSession(cfg, mesh=mesh, ...)   # this rank's own card
    results = session.device_pipeline().run_many(mine)
"""

from __future__ import annotations

import logging
import os
from datetime import timedelta

import torch
import torch.distributed as tdist

from ..device import resolve_device

logger = logging.getLogger("retto_tpu_torch.parallel")

__all__ = [
    "initialize",
    "is_initialized",
    "process_index",
    "process_count",
    "host_shard",
    "global_mesh",
]

_initialized = False


def _env_int(name: str) -> int | None:
    v = os.environ.get(name)
    return int(v) if v else None


def initialize(
    coordinator_address: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
    device: str | torch.device = "cuda",
    timeout_s: float = 300.0,
) -> bool:
    """Form the process group for a multi-process run.

    The coordinator (``host:port``), the number of processes and this
    process's rank come from the arguments or torchrun's environment
    (``MASTER_ADDR``/``MASTER_PORT``, ``WORLD_SIZE``, ``RANK``); the local
    rank from ``LOCAL_RANK`` (else the rank modulo this host's cards).
    ``device="cuda"`` (the default, which raises without a card) takes NCCL
    and sets this process's card to ``cuda:LOCAL_RANK``; ``device="cpu"``
    takes gloo.  ``init_process_group`` waits at most ``timeout_s`` for
    the other ranks.  Returns True when a group was formed, False for the
    single-process no-op (no coordinator configured)."""
    global _initialized
    if _initialized:
        return True
    if coordinator_address is None and os.environ.get("MASTER_ADDR"):
        coordinator_address = (f"{os.environ['MASTER_ADDR']}:"
                               f"{os.environ.get('MASTER_PORT', '29500')}")
    if num_processes is None:
        num_processes = _env_int("WORLD_SIZE")
    if process_id is None:
        process_id = _env_int("RANK")
    if coordinator_address is None and num_processes is None:
        logger.info("distributed.initialize: single-process (no coordinator)")
        return False
    if coordinator_address is None or num_processes is None or process_id is None:
        raise ValueError(
            "distributed.initialize needs the coordinator address, the number of "
            f"processes and this process's rank; got {coordinator_address!r}, "
            f"{num_processes!r}, {process_id!r}"
        )
    dev = resolve_device(device)
    backend = "nccl" if dev.type == "cuda" else "gloo"
    if dev.type == "cuda":
        local = _env_int("LOCAL_RANK")
        torch.cuda.set_device(process_id % torch.cuda.device_count() if local is None else local)
    tdist.init_process_group(
        backend=backend, init_method=f"tcp://{coordinator_address}",
        world_size=num_processes, rank=process_id, timeout=timedelta(seconds=timeout_s),
    )
    _initialized = True
    logger.info("distributed.initialize: process %d/%d over %s", process_id, num_processes,
                backend)
    return True


def is_initialized() -> bool:
    return _initialized


def _group_formed() -> bool:
    return tdist.is_available() and tdist.is_initialized()


def process_index() -> int:
    return tdist.get_rank() if _group_formed() else 0


def process_count() -> int:
    return tdist.get_world_size() if _group_formed() else 1


def host_shard(items, index: int | None = None, count: int | None = None):
    """This process's slice of a work list (per-process input dispatch).

    Strided split (``items[index::count]``) so early-exit or straggler
    processes hold evenly interleaved work; order within a process is
    preserved.  The caller reassembles globally by (process, position)."""
    index = process_index() if index is None else index
    count = process_count() if count is None else count
    if not 0 <= index < count:
        raise ValueError(f"process index {index} not in [0, {count})")
    return list(items)[index::count]


def global_mesh(model_parallel: int = 1):
    """``('data', 'model')`` ``DeviceMesh`` over every rank of the process
    group, of shape ``(world // model_parallel, model_parallel)``, on the
    group's device type (CUDA for NCCL, CPU for gloo).  Raises when no group
    is formed: call :func:`initialize` first."""
    if not _group_formed():
        raise RuntimeError("global_mesh needs a process group: call initialize() first")
    from torch.distributed.device_mesh import init_device_mesh

    world = tdist.get_world_size()
    if world % model_parallel:
        raise ValueError(f"{world} ranks not divisible by model_parallel={model_parallel}")
    device_type = "cuda" if tdist.get_backend() == "nccl" else "cpu"
    return init_device_mesh(device_type, (world // model_parallel, model_parallel),
                            mesh_dim_names=("data", "model"))
