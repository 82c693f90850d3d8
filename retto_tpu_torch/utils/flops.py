"""FLOP / MFU accounting for torch functions.

Port of ``retto_tpu/utils/flops.py:21-63``: per-op time alone cannot say
whether a kernel is fast; it must be compared with the device's peak.
``cost_of`` counts a function's FLOPs with PyTorch's
``torch.utils.flop_counter.FlopCounterMode``; ``mfu`` turns a measured
wall time into model-FLOPs utilization against the device's peak.

Peaks: the NVIDIA H100 SXM (80 GB HBM3), 989 TFLOP/s bf16 dense on the
tensor cores and 3.35 TB/s of HBM3, the card's published figures (PERF.md
§3); ``"cpu"`` is an order of magnitude only.
"""

from __future__ import annotations

from typing import Any

import torch

__all__ = ["PEAKS", "cost_of", "mfu", "device_peak_flops"]

# (peak dense FLOP/s at bf16, memory bytes/s), keyed by the name
# torch.cuda.get_device_name gives
PEAKS: dict[str, tuple[float, float]] = {
    "NVIDIA H100 80GB HBM3": (989e12, 3.35e12),
    "cpu": (1e11, 5e10),  # order-of-magnitude only (host fallback)
}


def device_peak_flops(device: str | torch.device | None = None) -> tuple[float, float]:
    """(peak_flops, peak_bytes) for ``device`` (default: card 0 when there
    is one, else the CPU).  A name missing from :data:`PEAKS` matches an
    entry whose name it contains, ignoring case and spaces, else ``"cpu"``."""
    dev = torch.device(device) if device is not None else (
        torch.device("cuda") if torch.cuda.is_available() else torch.device("cpu"))
    if dev.type != "cuda":
        return PEAKS["cpu"]
    name = torch.cuda.get_device_name(dev)
    if name in PEAKS:
        return PEAKS[name]
    key = name.lower().replace(" ", "")
    for k, peaks in PEAKS.items():
        if k != "cpu" and k.lower().replace(" ", "") in key:
            return peaks
    return PEAKS["cpu"]


def cost_of(fn, *args, **kwargs) -> dict[str, Any]:
    """Run ``fn(*args, **kwargs)`` once under ``FlopCounterMode`` and return
    {"flops": float, "bytes": float}.  ``flops`` counts what PyTorch's
    counter models: matmuls, convolutions and attention, two FLOPs per
    multiply-add (elementwise ops count 0).  ``bytes`` is the size of the
    tensor arguments plus the tensor outputs, each read or written once: a
    lower bound of the memory traffic (XLA's "bytes accessed" in the JAX
    package also counts intermediates).  Returns zeros when the function
    cannot be counted."""
    from torch.utils.flop_counter import FlopCounterMode

    def nbytes(obj) -> int:
        if isinstance(obj, torch.Tensor):
            return obj.numel() * obj.element_size()
        if isinstance(obj, (list, tuple)):
            return sum(nbytes(o) for o in obj)
        if isinstance(obj, dict):
            return sum(nbytes(o) for o in obj.values())
        return 0

    try:
        counter = FlopCounterMode(display=False)
        with counter, torch.no_grad():
            out = fn(*args, **kwargs)
        return {
            "flops": float(counter.get_total_flops()),
            "bytes": float(nbytes(args) + nbytes(kwargs) + nbytes(out)),
        }
    except Exception:  # noqa: BLE001 - accounting must never break the run
        return {"flops": 0.0, "bytes": 0.0}


def mfu(flops: float, seconds: float, device: str | torch.device | None = None) -> float:
    """Model-FLOPs-utilization of a measured run (0..1)."""
    if seconds <= 0 or flops <= 0:
        return 0.0
    peak, _ = device_peak_flops(device)
    return flops / seconds / peak
