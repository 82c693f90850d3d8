"""Build helpers for the port's native code.

The port compiles two shared libraries with a plain C interface at first
use and loads them with ``ctypes``: the C++ postprocess (``g++``,
``native/postprocess.cpp``) and the CUDA kernels (``nvcc``,
``csrc/*.cu``).  Both land in ``.torch_build/`` beside the package (listed
in ``.gitignore``).  A build writes a private temporary file and renames it
into place, so concurrent processes (pytest workers) never load a
half-written library.
"""

from __future__ import annotations

import os
import subprocess
from pathlib import Path

__all__ = ["BUILD_DIR", "build_shared"]

BUILD_DIR = Path(__file__).resolve().parent.parent / ".torch_build"


def build_shared(
    cmd_prefix: list[str], sources: list[Path], out_name: str, timeout: float
) -> Path:
    """Compile ``sources`` into ``BUILD_DIR/out_name`` with ``cmd_prefix``
    (the compiler and its flags; ``-o <tmp> <sources>`` is appended), unless
    the library is newer than every source.  The compiler's output goes to
    ``BUILD_DIR/<out_name>.log``.  Raises ``RuntimeError`` with the
    compiler's stderr on failure, ``subprocess.TimeoutExpired`` after
    ``timeout`` seconds."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    out = BUILD_DIR / out_name
    newest = max(s.stat().st_mtime for s in sources)
    if out.exists() and out.stat().st_mtime >= newest:
        return out
    tmp = out.with_name(f"{out_name}.{os.getpid()}.tmp")
    cmd = [*cmd_prefix, "-o", str(tmp), *map(str, sources)]
    try:
        done = subprocess.run(cmd, capture_output=True, text=True, timeout=timeout,
                              check=True)
        out.with_name(f"{out_name}.log").write_text(done.stdout + done.stderr)
        os.replace(tmp, out)
    except subprocess.CalledProcessError as e:
        raise RuntimeError(
            f"build of {out_name} failed ({' '.join(cmd)}):\n{e.stderr}"
        ) from e
    finally:
        tmp.unlink(missing_ok=True)
    return out
