"""The port stands alone: no file of retto_tpu_torch/, and not
chip_smoke.py, imports jax, flax, optax, orbax or the JAX package
retto_tpu; PIL is
imported only inside functions (the card's machine need not have it), and
chip_smoke.py imports neither PIL nor pytest."""

from __future__ import annotations

import ast
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
PORT_FILES = sorted((ROOT / "retto_tpu_torch").rglob("*.py"))
BANNED = ("jax", "flax", "optax", "orbax", "retto_tpu")


def _imports(tree: ast.AST):
    """(module name, at module level) for every import in ``tree``."""
    out = []

    def visit(node, in_func):
        for child in ast.iter_child_nodes(node):
            f = in_func or isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef,
                                              ast.Lambda))
            if isinstance(child, ast.Import):
                out.extend((a.name, not in_func) for a in child.names)
            elif isinstance(child, ast.ImportFrom) and child.level == 0:
                out.append((child.module or "", not in_func))
            visit(child, f)

    visit(tree, False)
    return out


def _root(name: str) -> str:
    return name.split(".")[0]


def test_port_has_files():
    assert len(PORT_FILES) > 20


@pytest.mark.parametrize("path", PORT_FILES + [ROOT / "chip_smoke.py"],
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_and_lazy_pil(path):
    mods = _imports(ast.parse(path.read_text(), str(path)))
    for name, top in mods:
        assert _root(name) not in BANNED, f"{path.name} imports {name}"
        if _root(name) == "PIL":
            assert not top, f"{path.name} imports PIL at module level"
    if path.name == "chip_smoke.py":
        assert not {_root(n) for n, _ in mods} & {"PIL", "pytest"}


def test_importing_the_port_loads_no_jax_or_pil():
    code = ("import sys, retto_tpu_torch, retto_tpu_torch.pipeline, "
            "retto_tpu_torch.ops.db_pack, retto_tpu_torch.kernels; "
            "bad = [m for m in ('jax', 'flax', 'retto_tpu', 'PIL') if m in sys.modules]; "
            "print(bad); sys.exit(1 if bad else 0)")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_cli_and_serve_entry_points_load_no_jax():
    """The user programs of the port: importing ``retto_tpu_torch.cli`` and
    ``retto_tpu_torch.serve`` and running ``main(["--help"])`` loads no
    jax, flax or retto_tpu module."""
    code = ("import sys, retto_tpu_torch.cli as cli, retto_tpu_torch.serve\n"
            "try:\n    cli.main(['--help'])\nexcept SystemExit as e:\n    assert e.code == 0\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'flax', 'retto_tpu')]\n"
            "print(bad); sys.exit(1 if bad else 0)")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "retto-torch" in proc.stdout


@pytest.mark.parametrize("module", ["retto_tpu_torch.weights.onnx_proto",
                                    "retto_tpu_torch.weights.onnx_bridge",
                                    "retto_tpu_torch.weights.replica",
                                    "retto_tpu_torch.pipeline.onnx_engine",
                                    "retto_tpu_torch.utils.flops"])
def test_onnx_path_modules_load_no_jax(module):
    """The ONNX path and the FLOP accounting, each imported alone in a fresh
    interpreter, load no jax, flax, retto_tpu or PIL module."""
    code = (f"import sys, {module}\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'flax', 'retto_tpu', 'PIL')]\n"
            "print(bad); sys.exit(1 if bad else 0)")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
