"""What the three probes share: the timing of one device function, the rows
they print, the session and the pages they measure."""

from __future__ import annotations

import math
import statistics
import subprocess
import time
from dataclasses import dataclass
from pathlib import Path
from typing import Callable

import numpy as np
import torch

from ..utils.flops import cost_of, mfu

REPO = Path(__file__).resolve().parents[2]
WEIGHTS = REPO / "trained_weights"
PAGES = REPO / "retto_tpu_torch" / "testdata" / "smoke_pages.npz"


@dataclass
class Row:
    """One measured function: ``ms`` the best and ``median_ms`` the median
    of the warm calls (each ended by a device synchronize), ``flops`` what
    ``utils.flops.cost_of`` counts (0 where the JAX tool prints none) and
    ``mfu`` against the device's peak; ``kind`` is "device" (the card's
    work: a captured graph's replay or an eager function), "transfer" or
    "host"; ``per_call`` how many times one pipeline call runs it."""

    label: str
    ms: float
    median_ms: float
    flops: float = 0.0
    mfu: float = 0.0
    kind: str = "device"
    per_call: int = 1

    def line(self) -> str:
        text = f"{self.label}: {self.ms:.3f} ms (median {self.median_ms:.3f})"
        if self.flops:
            text += f"  ({self.flops / 1e9:.2f} GF, MFU {self.mfu * 100:.2f}%)"
        return text


def sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def time_call(fn: Callable[[], object], device: torch.device, iters: int,
              warm: int = 2) -> tuple[float, float]:
    """(best, median) seconds of ``iters`` calls of ``fn`` after ``warm``
    calls, each call timed alone between two synchronizes."""
    for _ in range(warm):
        fn()
    sync(device)
    times = []
    for _ in range(max(iters, 1)):
        t0 = time.perf_counter()
        fn()
        sync(device)
        times.append(time.perf_counter() - t0)
    return min(times), statistics.median(times)


def measure_row(label: str, fn: Callable[[], object], device: torch.device, iters: int,
                flops: float = 0.0, kind: str = "device", per_call: int = 1) -> Row:
    best, med = time_call(fn, device, iters)
    return Row(label, best * 1e3, med * 1e3, flops, mfu(flops, best, device) if flops else 0.0,
               kind, per_call)


def flops_of(fn: Callable, *args) -> float:
    """``utils.flops.cost_of``'s count of ``fn(*args)``.  On the CPU the
    port's convs and dots run in the native library's XLA order, which the
    counter cannot see: the count runs with the library switched off, so
    the convs and matmuls count and the dots in XLA's order (term by term)
    do not."""
    if any(isinstance(a, torch.Tensor) and a.is_cuda for a in args):
        return cost_of(fn, *args)["flops"]
    from .. import native

    with native.switched_off():
        return cost_of(fn, *args)["flops"]


class Timer:
    """Times functions of tensors through one graph cache (replays on the
    card, eager calls on the CPU)."""

    def __init__(self, dev: torch.device, iters: int):
        from ..pipeline.graphs import GraphCache

        self.dev, self.iters = dev, iters
        self.cache = GraphCache(dev)
        self.rows: list[Row] = []

    def __call__(self, label: str, fn, *args, flops: bool = True) -> Row:
        def tupled(*t):
            out = fn(*t)
            return tuple(out) if isinstance(out, (list, tuple)) else (out,)

        key = (label, tuple(tuple(a.shape) for a in args))
        row = measure_row(label, lambda: self.cache.run(key, tupled, *args), self.dev,
                          self.iters, flops_of(fn, *args) if flops else 0.0)
        self.rows.append(row)
        return row


def card_line(device: torch.device) -> str:
    """The card's name and power limit as ``nvidia-smi`` prints them, or the
    CPU's description."""
    if device.type != "cuda":
        return f"cpu ({torch.get_num_threads()} threads)"
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=30, check=True).stdout.strip().splitlines()
        return out[device.index or 0] if out else torch.cuda.get_device_name(device)
    except (OSError, subprocess.SubprocessError):
        return torch.cuda.get_device_name(device)


def print_rows(rows: list[Row]) -> None:
    for r in rows:
        print(r.line(), flush=True)


def check_rows(rows: list[Row]) -> list[str]:
    """The rows' faults: a time that is 0 or not finite, an MFU above 1."""
    bad = []
    for r in rows:
        if not (math.isfinite(r.ms) and r.ms > 0 and math.isfinite(r.median_ms)):
            bad.append(f"{r.label}: time {r.ms}")
        if not math.isfinite(r.mfu) or r.mfu > 1.0:
            bad.append(f"{r.label}: MFU {r.mfu}")
    return bad


def session(device: str, weights: str | None, preset: str = "mobile",
            transfer: str = "yuv420", symmetrize: bool | None = None):
    """A PERFORMANCE session on ``device``: the checkpoints ``det``/``cls``/
    ``rec.npz`` of the directory ``weights`` with its ``charset.txt`` (the
    ASCII charset when it has none), or ``preset``'s random weights when
    ``weights`` is None (as the JAX tools build theirs)."""
    from ..config import SessionConfig
    from ..ops.charset import CharacterDict, ascii_charset
    from ..pipeline.session import RettoSession

    cfg = SessionConfig()
    cfg.engine.transfer_format = transfer
    if symmetrize is not None:
        cfg.cls.symmetrize = symmetrize
    files = None
    chars = CharacterDict(ascii_charset())
    if weights is not None:
        d = Path(weights)
        files = {k: str(d / f"{k}.npz") for k in ("det", "cls", "rec")}
        if (d / "charset.txt").exists():
            chars = CharacterDict((d / "charset.txt").read_text().splitlines())
    return RettoSession(cfg, preset=preset, charset=chars, weights=files, device=device)


def fixture_pages(n: int, size: tuple[int, int] | None = None) -> list[np.ndarray]:
    """``n`` RGB pages from the fixture's gray pages (960x704, bench.py's
    recipe), cycled, resized to ``size`` (h, w) when given."""
    gray = np.load(PAGES)["pages"]
    pages = []
    for i in range(n):
        p = gray[i % len(gray)]
        if size is not None and p.shape != tuple(size):
            ys = (np.arange(size[0]) * p.shape[0] // size[0])[:, None]
            xs = (np.arange(size[1]) * p.shape[1] // size[1])[None, :]
            p = p[ys, xs]
        pages.append(np.repeat(p[..., None], 3, axis=2))
    return pages


def add_device_args(ap) -> None:
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--weights", default=None,
                    help="directory of det/cls/rec .npz checkpoints (default: random "
                         "weights of --preset, as the JAX tool)")
    ap.add_argument("--preset", default="mobile")
