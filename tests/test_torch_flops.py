"""``retto_tpu_torch.utils.flops`` (port of ``retto_tpu/utils/flops.py``):
``cost_of`` on a conv and a matmul against their analytic FLOPs (two per
multiply-add, exact) and bytes (arguments and outputs, each once, exact),
zeros for what it cannot count, and the ``PEAKS`` lookup by the name
``torch.cuda.get_device_name`` gives."""

from __future__ import annotations

import pytest
import torch
import torch.nn.functional as F

from retto_tpu_torch.utils import flops
from retto_tpu_torch.utils.flops import PEAKS, cost_of, device_peak_flops, mfu


def test_cost_of_a_conv():
    x = torch.randn(2, 8, 16, 20)
    w = torch.randn(12, 8, 3, 3)
    c = cost_of(lambda a, b: F.conv2d(a, b, padding=1), x, w)
    out = 2 * 12 * 16 * 20
    assert c["flops"] == 2 * out * 8 * 3 * 3
    assert c["bytes"] == 4 * (x.numel() + w.numel() + out)


def test_cost_of_a_matmul():
    a, b = torch.randn(7, 33), torch.randn(33, 5)
    c = cost_of(torch.matmul, a, b)
    assert c["flops"] == 2 * 7 * 33 * 5
    assert c["bytes"] == 4 * (7 * 33 + 33 * 5 + 7 * 5)


def test_cost_of_returns_zeros_when_it_cannot_count():
    def broken(x):
        raise RuntimeError("no")

    assert cost_of(broken, torch.zeros(1)) == {"flops": 0.0, "bytes": 0.0}


def test_peaks_by_device_name(monkeypatch):
    assert PEAKS["NVIDIA H100 80GB HBM3"] == (989e12, 3.35e12)
    assert device_peak_flops("cpu") == PEAKS["cpu"]
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda d=None: "NVIDIA H100 80GB HBM3")
    assert device_peak_flops("cuda") == (989e12, 3.35e12)
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda d=None: "NVIDIA  H100 80GB HBM3 ")
    assert device_peak_flops("cuda") == (989e12, 3.35e12)
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda d=None: "Some Other Card")
    assert device_peak_flops("cuda") == PEAKS["cpu"]


def test_mfu(monkeypatch):
    monkeypatch.setattr(flops, "device_peak_flops", lambda device=None: (1e12, 1e11))
    assert mfu(5e11, 1.0) == pytest.approx(0.5)
    assert mfu(0.0, 1.0) == 0.0 and mfu(1.0, 0.0) == 0.0
