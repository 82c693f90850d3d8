"""Shared pieces of the benchmark's CPU tests: a cell cut to a size the CPU
runs in seconds (two 320 x 256 pages a batch, the det input side 256) with
the cell's own checkpoints, limits and metric entries."""

from __future__ import annotations

import json

import pytest

from benchmark import run as R


def tiny_spec(workload: str) -> dict:
    spec = R.load_cell(workload)
    mix = json.loads(json.dumps(spec["mix"]))
    mix["pages"]["sizes"] = [[320, 256]]
    mix["batch"], mix["pool_batches"], mix["judge_batches"] = 2, 2, 2
    spec["mix"] = mix
    cfg = json.loads(json.dumps(spec["config"]))
    cfg["session"]["det"]["limit_side_len"] = 256
    spec["config"] = cfg
    return spec


@pytest.fixture
def tiny():
    return tiny_spec
