"""The harness end to end on the CPU at a small size: a sound run is
correct, each planted fault and the fp8 control are not; and it refuses to
run without a card."""

import dataclasses
import json
import os
import shutil
import subprocess
import sys

import pytest
import torch

from benchmark import run as R
from benchmark.control import empty_half
from benchmark.reference.ocr import Reference, judge
from benchmark.traffic.pages import make_pool
from retto_tpu_torch.errors import RettoError

CELLS = [w["name"] for w in json.loads((R.ROOT / "BENCHMARK.json").read_text())["workloads"]]


def _run(spec, fault=None, trace=False):
    return R.run_cell(spec["cell"]["name"], 5, 1.0, trace, device="cpu", require_cuda=False,
                      spec=spec, fault=fault)


def _wrap(dp, change):
    orig = dp.run_many

    def run_many(inputs, *a, **k):
        return change(inputs, orig(inputs, *a, **k))
    dp.run_many = run_many


def half_left_out(dp):
    orig = dp.run_many

    def run_many(inputs, *a, **k):
        keep = len(inputs) // 2 or 1
        return orig(inputs[:keep], *a, **k) + [RettoError("left out")] * (len(inputs) - keep)
    dp.run_many = run_many


def a_page_fails_now_and_then(dp):
    """The last page of every other call fails, the window's first call
    among them."""
    orig, calls = dp.run_many, [0]

    def run_many(inputs, *a, **k):
        calls[0] += 1
        out = orig(inputs, *a, **k)
        return out[:-1] + [RettoError("failed")] if calls[0] % 2 else out
    dp.run_many = run_many


def _first_line(results):
    for r in results:
        if not isinstance(r, Exception) and r.rec_result.texts:
            return r
    raise AssertionError("no line served")


def text_altered(dp):
    def change(inputs, results):
        r = _first_line(results)
        t = r.rec_result.texts[0]
        swap = "#" if not t.text.startswith("#") else "$"
        r.rec_result.texts[0] = dataclasses.replace(t, text=swap + t.text[1:])
        return results
    _wrap(dp, change)


def cls_altered(dp):
    def change(inputs, results):
        r = _first_line(results)
        lab = r.cls_result.labels[0]
        r.cls_result.labels[0] = dataclasses.replace(lab, label=180 - lab.label)
        return results
    _wrap(dp, change)


def det_altered(dp):
    def change(inputs, results):
        for r in results:
            for b in r.det_result.boxes:
                b.score = b.score + 0.05
        return results
    _wrap(dp, change)


@pytest.mark.parametrize("cell", CELLS)
def test_a_sound_run_is_correct(tiny, cell):
    out = _run(tiny(cell), trace=cell == CELLS[0])
    assert out["correct"], out["checks"]
    assert list(out["checks"])[-1] == "unanswered" and list(out)[-1] == "checks"
    assert out["attempted"] > 0 and out["failed"] == 0


@pytest.mark.parametrize("fault", [half_left_out, empty_half, a_page_fails_now_and_then,
                                   text_altered, cls_altered, det_altered],
                         ids=lambda f: f.__name__)
def test_a_planted_fault_is_not_correct(tiny, fault):
    out = _run(tiny("mobile.batch16"), fault=fault)
    assert not out["correct"], out["checks"]


def test_pages_that_fail_are_counted_as_failed_not_served(tiny):
    out = _run(tiny("mobile.batch16"), fault=half_left_out)
    assert out["failed"] > 0 and out["failed"] * 2 == out["attempted"]
    assert out["checks"]["unanswered"]["value"] == out["failed"]


def test_the_fp8_control_is_not_correct(tiny):
    spec = tiny("mobile.batch16")
    pages = make_pool(spec["mix"], 7)
    ref = Reference(spec["config"], R.ROOT, torch.device("cpu"))
    control = Reference(spec["config"], R.ROOT, torch.device("cpu"), precision="fp8")
    nums = judge(ref, pages, control.answer(pages))
    nums["unanswered"] = 0
    correct, checks = R.check(nums, spec["limits"])
    assert not correct, checks


def test_refuses_without_a_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    proc = subprocess.run(
        [sys.executable, "-m", "benchmark.run", "--workload", CELLS[0], "--seed", "1",
         "--seconds", "1", "--trace", "0"], cwd=R.ROOT, capture_output=True, text=True,
        timeout=300)
    assert proc.returncode != 0 and proc.stdout.strip() == ""
    assert "CUDA card" in proc.stderr


def test_refuses_without_the_program(tmp_path):
    shutil.copy(R.ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(R.HERE, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    env = dict(os.environ, PYTHONPATH="")
    proc = subprocess.run(
        [sys.executable, "-m", "benchmark.run", "--workload", CELLS[0], "--seed", "1",
         "--seconds", "1", "--trace", "0"], cwd=tmp_path, capture_output=True, text=True,
        timeout=300, env=env)
    assert proc.returncode != 0 and proc.stdout.strip() == ""


@pytest.mark.cuda
def test_a_short_run_on_the_card_is_correct():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    proc = subprocess.run(
        [sys.executable, "-m", "benchmark.run", "--workload", CELLS[0], "--seed", "11",
         "--seconds", "2", "--trace", "0"], cwd=R.ROOT, capture_output=True, text=True,
        timeout=600)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert json.loads(proc.stdout.strip().splitlines()[-1])["correct"]

