"""The port's CUDA kernels: built by ``nvcc`` at first use, loaded with
``ctypes``.

All sources under ``csrc/`` compile into one shared library with a plain C
interface (no PyTorch headers, so the build takes seconds):

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \\
         -Xcompiler -fPIC -Xptxas -v -o .torch_build/libretto_kernels.so csrc/*.cu

(``-Xptxas -v``: each kernel's registers, shared memory and spills, kept
in ``.torch_build/libretto_kernels.so.log``.)

Each C launcher takes device pointers, ints and the CUDA stream, launches
on that stream and returns ``cudaGetLastError()``; the wrappers (for
example ``ops.db_pack``) check their inputs, allocate outputs with
``torch.empty`` and raise when the launcher reports an error.
"""

from __future__ import annotations

import ctypes
import os
import shutil
from pathlib import Path

from ._build import BUILD_DIR, build_shared

__all__ = ["COUNTED", "NVCC_FLAGS", "load", "check_launch", "build_log"]

CSRC = Path(__file__).resolve().parent / "csrc"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]
_LIB: ctypes.CDLL | None = None
# the wrappers that count their launches in ``.launches`` (each ops module
# adds its own); ``pipeline.graphs`` adds a graph's launches on every replay
COUNTED: list = []


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    return str(Path(home) / "bin" / "nvcc")


def load() -> ctypes.CDLL:
    """Build (unless up to date) and load the kernel library; raises with
    nvcc's stderr when the build fails."""
    global _LIB
    if _LIB is None:
        path = build_shared([_nvcc(), *NVCC_FLAGS], sorted(CSRC.glob("*.cu")),
                            "libretto_kernels.so", timeout=300)
        lib = ctypes.CDLL(str(path))
        vp, ci = ctypes.c_void_p, ctypes.c_int
        lib.rt_db_epilogue.restype = ci
        lib.rt_db_epilogue.argtypes = [vp, vp, vp, ci, ci, ci, ci, ctypes.c_float, ci, ci,
                                       ci, vp]
        lib.rt_cuda_error_string.restype = ctypes.c_char_p
        lib.rt_cuda_error_string.argtypes = [ci]
        _LIB = lib
    return _LIB


def build_log() -> str:
    """What nvcc and ptxas printed for the last build (registers, spills)."""
    log = BUILD_DIR / "libretto_kernels.so.log"
    return log.read_text() if log.exists() else ""


def check_launch(lib: ctypes.CDLL, err: int, name: str) -> None:
    if err:
        msg = lib.rt_cuda_error_string(err).decode()
        raise RuntimeError(f"{name}: CUDA launch failed ({err}: {msg})")
