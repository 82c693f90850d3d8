"""The ``retto-torch`` CLI (``retto_tpu_torch.cli``) in subprocesses on the
CPU, against the JAX CLI (``retto_tpu.cli``) on the same directory and
weights: fixture pages 1 and 3 as PNGs, the shipped mobile checkpoints,
staged and with ``--device-pipeline``.  The JSONL texts must be equal
(scores are not compared: the CPU conv sums differ in the last bits,
ROADMAP Queue 3), and the port's process must load no ``jax``, ``flax`` or
``retto_tpu`` module."""

from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
from PIL import Image

REPO = Path(__file__).resolve().parent.parent
WEIGHTS = REPO / "trained_weights"
BANNED = ("jax", "flax", "retto_tpu")


def run_port(args: list[str], timeout: int = 600) -> subprocess.CompletedProcess:
    """``retto_tpu_torch.cli.main(args)``; exits 3 when a banned module got
    loaded, else with main's code."""
    code = (
        "import sys; sys.path.insert(0, {repo!r}); "
        "from retto_tpu_torch.cli import main; rc = main({args!r}); "
        "bad = [m for m in sys.modules if m.split('.')[0] in {banned!r}]; "
        "print('BANNED', bad, file=sys.stderr) if bad else None; "
        "sys.exit(3 if bad else rc)"
    ).format(repo=str(REPO), args=args, banned=BANNED)
    return subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          timeout=timeout, cwd=REPO)


def run_jax(args: list[str]) -> subprocess.CompletedProcess:
    code = (f"import jax; jax.config.update('jax_platforms', 'cpu'); import sys; "
            f"sys.path.insert(0, {str(REPO)!r}); from retto_tpu.cli import main; "
            f"sys.exit(main({args!r}))")
    return subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          timeout=600, cwd=REPO)


@pytest.fixture(scope="module")
def page_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("cli_pages")
    pages = np.load(REPO / "retto_tpu_torch" / "testdata" / "smoke_pages.npz")["pages"]
    for i in (1, 3):
        Image.fromarray(pages[i]).save(d / f"page{i}.png")
    return d


def texts(path: Path) -> list[tuple[str, list[str]]]:
    lines = [json.loads(x) for x in path.read_text().splitlines()]
    return [(Path(x["file"]).name, [t["text"] for t in x["texts"]]) for x in lines]


@pytest.mark.parametrize("extra", [[], ["--device-pipeline"]], ids=["staged", "fused"])
def test_ocr_texts_equal_the_jax_cli(page_dir, tmp_path, extra):
    common = ["ocr", str(page_dir), "--weights-dir", str(WEIGHTS)] + extra
    port = run_port(common + ["--device", "cpu", "--json-out", str(tmp_path / "t.jsonl")])
    assert port.returncode == 0, port.stderr
    assert "processed 2 images" in port.stderr
    ref = run_jax(common + ["--json-out", str(tmp_path / "j.jsonl")])
    assert ref.returncode == 0, ref.stderr
    got = texts(tmp_path / "t.jsonl")
    assert got == texts(tmp_path / "j.jsonl")
    assert sum(len(t) for _, t in got) == 8


def test_help_and_info_cpu_load_no_jax():
    r = run_port(["--help"])
    assert r.returncode == 0 and "ocr" in r.stdout and "serve" in r.stdout
    r = run_port(["info", "--device", "cpu"])
    assert r.returncode == 0, r.stderr
    assert "retto-tpu-torch" in r.stdout and "torch" in r.stdout


def test_cuda_without_a_card_exits_1(page_dir, capsys):
    import torch

    from retto_tpu_torch.cli import main

    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    for args in (["ocr", str(page_dir)], ["ocr", str(page_dir), "--device", "auto"],
                 ["info"], ["serve", "--port", "0"]):
        assert main(args) == 1, args
        assert "--device cpu" in capsys.readouterr().err


def test_not_ported_paths_exit_1_with_a_message(page_dir, tmp_path, capsys):
    from retto_tpu_torch.cli import main

    assert main(["ocr", str(page_dir), "--device", "cpu", "--hf-hub"]) == 1
    assert "not ported" in capsys.readouterr().err
    # every preset is ported now: tiny without weights runs on random ones
    out = tmp_path / "tiny.jsonl"
    assert main(["ocr", str(page_dir), "--device", "cpu", "--preset", "tiny",
                 "--weights-dir", str(tmp_path), "--json-out", str(out)]) == 0
    assert "not ported" not in capsys.readouterr().err
    assert len(out.read_text().splitlines()) == len(list(page_dir.glob("*.png")))
    assert main(["ocr", str(tmp_path), "--device", "cpu"]) == 1
    assert "no images" in capsys.readouterr().err
