"""The port's accuracy tools (``python -m retto_tpu_torch.train.eval_*``)
against the JAX tools (``tools/eval_*.py``) on the CPU at small n: the
same seeds render the same samples, and every line the tools print, the
summary counts and each MISS line, must be equal.

* ``eval_bigvocab_pipeline`` at 8 lines (2 pseudo-glyph pages); and at
  its default 64 lines against ``chip_smoke.py``'s eval fixture
  (``testdata/smoke_eval_bigvocab.json``, the JAX tool's run, written by
  ``tests/torch_eval_fixture.py``): the printed lines equal, and at least
  ``EVAL_MATCH_MIN`` of the lines' texts equal (``agreement``): all 65,
  now that the port's CPU arithmetic follows XLA:CPU's (the dot orders of
  ``models.common``, the crop warps' and the crop normalization's fused
  multiply-adds).  On the card, ``chip_smoke.py`` phase eval holds the
  tallies and which lines are read right, where the texts of misread
  lines can differ (cuDNN's and cuBLAS's sums);
* ``eval_accuracy`` at 2 samples, staged and ``--fused``;
* ``eval_heldout`` at 1 sample per condition, every condition, with
  ``multiline`` first so that its page draws hold 3 or more lines.

The JAX tools run in this process (``sys.argv`` replaced), the port's
through ``main(argv)`` with ``--device cpu``."""

from __future__ import annotations

import contextlib
import importlib
import importlib.util
import io
import json
import sys
from pathlib import Path

import jax  # noqa: F401  (the JAX tools run in this process, on the CPU)
import pytest

ROOT = Path(__file__).resolve().parent.parent
HELDOUT_CONDS = ("multiline,size_small,size_large,offset,contrast,noise_jpeg,"
                 "font_heldout")
EVAL_MATCH_MIN = 1.0
CASES = {
    "bigvocab": ("eval_bigvocab_pipeline", ["8"]),
    "accuracy_staged": ("eval_accuracy", ["2"]),
    "accuracy_fused": ("eval_accuracy", ["2", "--fused"]),
    "heldout": ("eval_heldout", ["1", f"--conds={HELDOUT_CONDS}"]),
}


def _jax_tool(name: str, args: list[str], monkeypatch) -> list[str]:
    # the tool sets a compilation cache directory in the environment as it
    # is imported; monkeypatch puts the environment back
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    spec = importlib.util.spec_from_file_location(f"jax_{name}", ROOT / "tools" / f"{name}.py")
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    monkeypatch.setattr(sys, "argv", [name, *args])
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        tool.main()
    return out.getvalue().splitlines()


def _port_tool(name: str, args: list[str]) -> list[str]:
    tool = importlib.import_module(f"retto_tpu_torch.train.{name}")
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        tool.main([*args, "--device", "cpu"])
    return out.getvalue().splitlines()


@pytest.mark.parametrize("case", CASES)
def test_port_tool_prints_the_jax_tools_lines(case, monkeypatch):
    name, args = CASES[case]
    want = _jax_tool(name, args, monkeypatch)
    got = _port_tool(name, args)
    assert got == want
    summary = {"bigvocab": "[big-pipe] rec exact line match:",
               "accuracy_staged": "rec exact:", "accuracy_fused": "rec exact:",
               "heldout": "multiline    boxes-exact pages"}[case]
    assert any(line.startswith(summary) for line in got), got
    if case == "heldout":  # every condition ran, multiline on at least one page
        for cond in HELDOUT_CONDS.split(","):
            assert any(line.startswith(cond + " ") for line in got), cond
        assert not any("pages 0/0" in line for line in got), got


def test_bigvocab_evaluate_against_the_smoke_fixture():
    """``evaluate`` (what chip_smoke.py's eval phase calls) at 64 lines on
    the CPU: the tool's printed lines are the JAX tool's, and the texts per
    page agree with the fixture's by the phase's rule."""
    from retto_tpu_torch.train import eval_bigvocab_pipeline as ev
    from torch_eval_fixture import FIXTURE

    fixture = json.loads(FIXTURE.read_text(encoding="utf-8"))
    logs: list[str] = []
    with ev.big_session("cpu") as session:
        res = ev.evaluate(session, fixture["n"], log=logs.append)
    printed = [f"[big-pipe] {session.chars.num_classes} classes", *logs, *ev.summary(res)]
    assert printed == fixture["printed"]
    assert res.ok + len(res.misses) == res.total
    assert res.det_ok == sum(len(t) for g, t in zip(res.got, res.gts) if len(g) == len(t))
    equal, total = ev.agreement(res.got, fixture["texts"])
    assert total == res.total and equal >= EVAL_MATCH_MIN * total, (equal, total)
