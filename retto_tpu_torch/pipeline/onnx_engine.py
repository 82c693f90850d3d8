"""OnnxEngine — run the reference's actual ONNX artifacts on the card.

Port of ``retto_tpu/pipeline/onnx_engine.py:28-108``, the analog of the
reference's only worker, ``RettoOrtWorker`` (ort_worker.rs:120-221): three
sessions built from det/cls/rec model sources.  Each ``.onnx`` graph is
translated to torch calls (``weights.onnx_bridge``) and run eagerly in
float32 in place of ONNX Runtime; the fused ``DevicePipeline`` captures
it in CUDA graphs.

    from retto_tpu_torch import OnnxEngine, RettoSession, SessionConfig
    engine = OnnxEngine(det="det.onnx", cls=cls_bytes, rec=Path("rec.onnx"))
    session = RettoSession(SessionConfig(), engine=engine, charset=chars)
    session.run(png_bytes)                          # staged
    session.device_pipeline().run_many(pages)       # fused

The weights are the graphs' ONNX initializers: both packages parse them
from the same bytes (``weights.onnx_proto``), and ``params()`` exposes
them as tensors on the device.

Model sources mirror RettoWorkerModelSource (worker.rs:16-57): a path, a
blob (bytes), or a HuggingFace repo spec (resolved through
``huggingface_hub`` where the environment has it and a network).
"""

from __future__ import annotations

import threading
from pathlib import Path
from typing import Any

import torch
from torch import nn

from ..device import resolve_device
from ..errors import ModelNotFoundError, RettoEngineError
from ..weights.onnx_bridge import OnnxFunction, _device_value, build_fn

__all__ = ["OnnxEngine", "OnnxModule", "resolve_model_source"]


class OnnxModule(nn.Module):
    """A translated ONNX graph and its initializers on the device, called as
    ``module(x)`` with NCHW float32 ``x`` (ort_worker.rs:188-221 contract:
    det [N,1,H,W], cls [N,2], rec [N,T,C] out; a graph with several
    outputs returns its first).  The initializers are buffers, in the
    graph's order, so ``.to()`` and ``.buffers()`` see them."""

    def __init__(self, fn: OnnxFunction, params: dict[str, torch.Tensor]):
        super().__init__()
        self.fn = fn
        self.names = list(params)
        for i, t in enumerate(params.values()):
            self.register_buffer(f"init_{i}", t, persistent=False)
        self.training = False

    def params(self) -> dict[str, torch.Tensor]:
        return {n: getattr(self, f"init_{i}") for i, n in enumerate(self.names)}

    def forward(self, x: torch.Tensor, **_) -> torch.Tensor:
        out = self.fn(self.params(), x)
        return out[0] if isinstance(out, tuple) else out


def resolve_model_source(source: Any) -> bytes:
    """Path / bytes / {"repo": ..., "file": ...} -> model bytes
    (worker.rs:30-56 ``resolve``)."""
    if isinstance(source, (bytes, bytearray)):
        if not source:
            raise ModelNotFoundError("Empty model blob!")
        return bytes(source)
    if isinstance(source, dict):
        try:
            from huggingface_hub import hf_hub_download
        except ImportError as e:
            raise ModelNotFoundError(
                f"huggingface_hub unavailable for {source}"
            ) from e
        path = hf_hub_download(source["repo"], source["file"])
        return Path(path).read_bytes()
    p = Path(source)
    if not p.exists():
        raise ModelNotFoundError(str(p))
    return p.read_bytes()


class OnnxEngine:
    """Engine protocol implementation backed by translated ONNX graphs
    (onnx_engine.py:61-108).

    det/cls/rec accept NCHW float32 like the reference worker
    (worker.rs:69-73); any of them may be None, and a stage without a
    graph raises ``RettoEngineError``.  Every forward runs under
    ``torch.inference_mode()`` and ``lock``, the dispatch lock a session
    shares with its fused ``DevicePipeline`` (``TorchEngine.lock``).  On
    CUDA TF32 is off: the graphs compute in full float32.  Outputs stay on
    the device."""

    def __init__(self, det: Any = None, cls: Any = None, rec: Any = None,
                 device: str | torch.device = "cuda",
                 lock: threading.RLock | None = None):
        self.device = resolve_device(device)
        if self.device.type == "cuda":
            torch.backends.cuda.matmul.allow_tf32 = False
            torch.backends.cudnn.allow_tf32 = False
        self.lock = lock if lock is not None else threading.RLock()
        self._modules: dict[str, OnnxModule] = {}
        for name, src in (("det", det), ("cls", cls), ("rec", rec)):
            if src is None:
                continue
            fn, params = build_fn(resolve_model_source(src))
            fn.prepare(self.device)
            on_dev = {k: _device_value(v, self.device) for k, v in params.items()}
            self._modules[name] = OnnxModule(fn, on_dev)

    # ---- DevicePipeline integration ---------------------------------- #
    def modules(self) -> dict[str, OnnxModule]:
        """The translated graphs as modules, for the fused DevicePipeline
        (``RettoSession.device_pipeline()`` uses them)."""
        return dict(self._modules)

    def params(self) -> dict[str, dict[str, torch.Tensor]]:
        """Per stage, the graph's initializers as device tensors."""
        return {name: m.params() for name, m in self._modules.items()}

    def _run(self, name: str, x) -> torch.Tensor:
        module = self._modules.get(name)
        if module is None:
            raise RettoEngineError(f"OnnxEngine has no '{name}' model")
        x = torch.as_tensor(x, dtype=torch.float32, device=self.device)
        with self.lock, torch.inference_mode():
            return module(x)

    def det(self, x) -> torch.Tensor:
        return self._run("det", x)

    def cls(self, x) -> torch.Tensor:
        return self._run("cls", x)

    def rec(self, x) -> torch.Tensor:
        return self._run("rec", x)
