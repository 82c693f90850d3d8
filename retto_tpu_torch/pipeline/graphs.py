"""A cache of captured CUDA graphs: the port's counterpart of ``jax.jit``'s
compile cache in the JAX pipeline (``_build_jits``,
``retto_tpu/pipeline/device_pipeline.py:320-680``).

``GraphCache.run(key, fn, *args)`` maps a static key (shapes and the static
arguments) to one captured ``torch.cuda.CUDAGraph`` of ``fn`` with static
input buffers and static outputs.  The first call of a key copies the
arguments into new static inputs, runs ``fn`` on them a few times on a side
stream (PyTorch's CUDA-graph notes: lazy initialisation, cuBLAS workspaces
and the kernels' first use, which builds them, happen outside the
capture), captures one call into the pool that every entry shares, and
replays it.  Later calls copy the arguments into the static inputs and
replay.  ``len(cache)`` counts the entries, as ``compile_count`` counts
XLA's compiles.

The outputs are the entry's static tensors: the next call of the same key
overwrites them.  A caller that keeps an output past that call copies it
first, on the same stream, right after the call (``DevicePipeline`` clones
the det chunk's image tensor and copies the other outputs to the host).

Kernel launch counts: a wrapper such as ``ops.db_pack.db_epilogue`` counts
its launches in its ``launches`` attribute when its Python code runs,
which inside a graph happens at capture only.  Each entry records how many
launches of each counted wrapper (``kernels.COUNTED``) its graph holds,
takes the capture's counts back (the capture launched nothing) and adds
them on every replay, so the counts stay the real number of launches.

On a CPU device the same cache runs ``fn`` eagerly on the entry's static
inputs and copies the results into the entry's static outputs, so the
tests on the CPU exercise the key scheme, the copies into static inputs and
the reuse of static outputs.  The CPU runs only when the caller asked for
it; nothing falls back to it.

Captures run with ``capture_error_mode="thread_local"``: the pipeline's
fetch threads wait on CUDA events while another thread captures, which
the default global mode forbids.  The caller serialises captures and
replays with every other dispatch (``DevicePipeline._lock``).
``capture_s`` sums the host seconds spent in warm-up and capture, the
``capture`` spans of ``timers`` (``utils.timing.StageTimers``; the range
``retto.capture key=...`` on a profiler's timeline).
"""

from __future__ import annotations

import contextlib
from typing import Callable, Hashable, Sequence

import torch

from .. import kernels
from ..utils.timing import StageTimers

__all__ = ["GraphCache"]

WARMUP_CALLS = 3


class _Entry:
    __slots__ = ("graph", "static_in", "static_out", "held")

    def __init__(self, static_in, static_out, graph=None, held=()):
        self.static_in = static_in
        self.static_out = static_out
        self.graph = graph
        self.held = held  # launches of each counted wrapper per replay


def on_device(device: torch.device):
    """``torch.cuda.device(device)`` for a CUDA device (its current stream
    becomes the current one), else nothing."""
    return torch.cuda.device(device) if device.type == "cuda" else contextlib.nullcontext()


class GraphCache:
    """Static key -> captured graph (CUDA) or static buffers (CPU), all on
    one device: a graph captured on one card cannot replay on another.
    Captures and replays run on that device's current stream."""

    def __init__(self, device: torch.device):
        self.device = device
        self._entries: dict[Hashable, _Entry] = {}
        cuda = device.type == "cuda"
        self._pool = torch.cuda.graph_pool_handle() if cuda else None
        # a capture stream on this card: ``torch.cuda.graph``'s default is
        # one stream for the whole process, on the card of its first use
        self._stream = torch.cuda.Stream(device) if cuda else None
        self.timers = StageTimers()

    def __len__(self) -> int:
        return len(self._entries)

    def __contains__(self, key: Hashable) -> bool:
        return key in self._entries

    @property
    def capture_s(self) -> float:
        return self.timers.totals.get("capture", 0.0)

    def run(self, key: Hashable, fn: Callable[..., Sequence[torch.Tensor]],
            *args: torch.Tensor) -> tuple[torch.Tensor, ...]:
        """``fn(*args)`` (a tuple of tensors) through the entry of ``key``;
        returns the entry's static outputs."""
        with on_device(self.device):
            return self._run(key, fn, args)

    def _run(self, key, fn, args) -> tuple[torch.Tensor, ...]:
        entry = self._entries.get(key)
        if entry is None:
            static_in = [a.clone() for a in args]
            if self.device.type == "cuda":
                with self.timers.time("capture", key=key):
                    entry = self._capture(fn, static_in)
            else:
                entry = _Entry(static_in, tuple(o.clone() for o in fn(*static_in)))
            self._entries[key] = entry
        else:
            for s, a in zip(entry.static_in, args):
                s.copy_(a)
            if entry.graph is None:
                for s, o in zip(entry.static_out, fn(*entry.static_in)):
                    s.copy_(o)
        if entry.graph is not None:
            entry.graph.replay()
            for wrapper, n in zip(kernels.COUNTED, entry.held):
                wrapper.launches += n
        return entry.static_out

    def _capture(self, fn, static_in: list[torch.Tensor]) -> _Entry:
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            for _ in range(WARMUP_CALLS):
                fn(*static_in)
        torch.cuda.current_stream().wait_stream(side)
        before = [w.launches for w in kernels.COUNTED]
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, pool=self._pool, stream=self._stream,
                              capture_error_mode="thread_local"):
            static_out = tuple(fn(*static_in))
        held = []
        for wrapper, n0 in zip(kernels.COUNTED, before):
            held.append(wrapper.launches - n0)
            wrapper.launches = n0
        return _Entry(static_in, static_out, graph, tuple(held))
