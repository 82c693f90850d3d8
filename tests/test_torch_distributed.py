"""``retto_tpu_torch.parallel.distributed`` (the cases of
tests/test_distributed.py): ``host_shard``, the single-process no-op, the
argument and environment plumbing of ``initialize`` (with
``init_process_group`` replaced), ``global_mesh`` at world size 1 over
gloo, and a two-process gloo loopback all-gather in subprocesses, on a
free port, with timeouts and the children killed on failure."""

from __future__ import annotations

import os
import socket
import subprocess
import sys
from datetime import timedelta
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.distributed as tdist

from retto_tpu.parallel import distributed as jdist
from retto_tpu_torch import RettoSession, SessionConfig
from retto_tpu_torch.parallel import distributed as dist

ROOT = Path(__file__).resolve().parent.parent
ENV = ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK", "LOCAL_RANK")


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


class TestHostShard:
    def test_explicit_strided_split(self):
        items = list(range(10))
        assert dist.host_shard(items, 0, 3) == [0, 3, 6, 9]
        assert dist.host_shard(items, 1, 3) == [1, 4, 7]
        assert dist.host_shard(items, 2, 3) == [2, 5, 8]

    def test_partition_covers_everything_disjointly(self):
        items = [f"img{i}" for i in range(23)]
        shards = [dist.host_shard(items, i, 5) for i in range(5)]
        flat = [x for s in shards for x in s]
        assert sorted(flat) == sorted(items) and len(flat) == len(set(flat))
        sizes = [len(s) for s in shards]
        assert max(sizes) - min(sizes) <= 1
        # the same split as the JAX helper's
        assert shards == [jdist.host_shard(items, i, 5) for i in range(5)]

    def test_order_preserved_within_host(self):
        items = list(range(12))
        for i in range(4):
            s = dist.host_shard(items, i, 4)
            assert s == sorted(s)

    def test_single_process_identity(self):
        assert dist.host_shard(["a", "b", "c"]) == ["a", "b", "c"]

    def test_invalid_index_raises(self):
        with pytest.raises(ValueError):
            dist.host_shard([1, 2], 2, 2)
        with pytest.raises(ValueError):
            dist.host_shard([1, 2], -1, 2)

    def test_accepts_any_iterable(self):
        assert dist.host_shard(iter(range(6)), 1, 2) == [1, 3, 5]


@pytest.fixture
def clean_env(monkeypatch):
    monkeypatch.setattr(dist, "_initialized", False)
    for var in ENV:
        monkeypatch.delenv(var, raising=False)
    return monkeypatch


class TestInitialize:
    def test_single_process_noop(self, clean_env):
        assert dist.initialize() is False
        assert dist.is_initialized() is False
        assert dist.process_index() == 0
        assert dist.process_count() == 1

    def test_argument_plumbing(self, clean_env):
        """The coordinator, count and rank reach ``init_process_group``;
        the CPU takes gloo; a second call does not init again."""
        calls = []
        clean_env.setattr(tdist, "init_process_group", lambda **kw: calls.append(kw))
        assert dist.initialize("10.0.0.1:1234", 4, 2, device="cpu", timeout_s=30) is True
        assert calls == [dict(backend="gloo", init_method="tcp://10.0.0.1:1234",
                              world_size=4, rank=2, timeout=timedelta(seconds=30))]
        assert dist.is_initialized() is True
        assert dist.initialize() is True
        assert len(calls) == 1

    def test_env_var_resolution(self, clean_env):
        calls = []
        clean_env.setattr(tdist, "init_process_group", lambda **kw: calls.append(kw))
        clean_env.setenv("MASTER_ADDR", "host0")
        clean_env.setenv("MASTER_PORT", "9999")
        clean_env.setenv("WORLD_SIZE", "2")
        clean_env.setenv("RANK", "1")
        assert dist.initialize(device="cpu") is True
        assert calls[0]["init_method"] == "tcp://host0:9999"
        assert (calls[0]["world_size"], calls[0]["rank"]) == (2, 1)

    def test_cuda_without_a_card_raises(self, clean_env):
        """The default device is CUDA (NCCL): without a card it raises,
        never falling back to gloo on the CPU."""
        calls = []
        clean_env.setattr(tdist, "init_process_group", lambda **kw: calls.append(kw))
        clean_env.setattr("torch.cuda.is_available", lambda: False)
        with pytest.raises(RuntimeError, match="CUDA"):
            dist.initialize("10.0.0.1:1234", 2, 0)
        assert not calls and dist.is_initialized() is False

    def test_partial_configuration_raises(self, clean_env):
        with pytest.raises(ValueError, match="rank"):
            dist.initialize("10.0.0.1:1234", 2, device="cpu")


def test_global_mesh_world_size_one_gloo(clean_env):
    """A real gloo group of one process: ``global_mesh`` is (1, 1) with the
    JAX axis names; a model axis the world does not divide raises; the
    driver of the module docstring runs (a session on the rank's own
    device over its ``host_shard``)."""
    with pytest.raises(RuntimeError, match="initialize"):
        dist.global_mesh()
    assert dist.initialize(f"127.0.0.1:{_free_port()}", 1, 0, device="cpu", timeout_s=60)
    try:
        mesh = dist.global_mesh()
        assert mesh.mesh_dim_names == ("data", "model")
        assert tuple(mesh.shape) == (1, 1) and mesh.device_type == "cpu"
        assert dist.process_count() == 1 and dist.process_index() == 0
        with pytest.raises(ValueError):
            dist.global_mesh(model_parallel=2)
        rng = np.random.default_rng(0)
        files = [rng.integers(0, 255, (96, 128, 3), dtype=np.uint8) for _ in range(3)]
        mine = dist.host_shard(files)
        with RettoSession(SessionConfig(), preset="tiny", mesh=mesh) as session:
            assert session.device == torch.device("cpu")
            results = session.device_pipeline().run_many(mine)
        assert len(results) == len(files) and all(hasattr(r, "det_result") for r in results)
    finally:
        tdist.destroy_process_group()


_LOOPBACK_WORKER = r"""
import sys
import torch
sys.path.insert(0, sys.argv[4])
import torch.distributed as tdist
from retto_tpu_torch.parallel import distributed as dist
ok = dist.initialize(sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), device="cpu", timeout_s=120)
assert ok and dist.is_initialized() and dist.process_count() == int(sys.argv[2])
mesh = dist.global_mesh()
assert tuple(mesh.shape) == (int(sys.argv[2]), 1)
mine = dist.host_shard(list(range(10)))
parts = [torch.zeros(1, dtype=torch.int64) for _ in range(dist.process_count())]
tdist.all_gather(parts, torch.tensor([sum(mine)]), group=mesh.get_group("data"))
print("SHARD", dist.process_index(), mine, int(torch.cat(parts).sum()), flush=True)
tdist.destroy_process_group()
"""


def test_two_process_loopback_all_gather(tmp_path):
    """Two gloo processes over loopback: one global mesh, a cross-process
    all-gather of each process's share of 0..9 (the sum is 45 on both)."""
    script = tmp_path / "worker.py"
    script.write_text(_LOOPBACK_WORKER)
    addr = f"127.0.0.1:{_free_port()}"
    env = dict(os.environ, OMP_NUM_THREADS="1")
    procs = [subprocess.Popen([sys.executable, str(script), addr, "2", str(i), str(ROOT)],
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, env=env,
                              text=True) for i in range(2)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=180))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for p, (out, err) in zip(procs, outs):
        assert p.returncode == 0, err[-2000:]
    lines = [out.split("SHARD", 1)[1].split() for out, _ in outs]
    assert sorted(w[0] for w in lines) == ["0", "1"]
    assert all(w[-1] == "45" for w in lines)
