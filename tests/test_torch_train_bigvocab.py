"""``python -m retto_tpu_torch.train.train_bigvocab`` on the CPU: two steps
of the 6,625-class rec on a small rendered set and one pipeline page
through the shipped det, in a subprocess; the checkpoint it writes loads
in both packages; its line set is the JAX tool's for the same seed."""

from __future__ import annotations

import importlib.util
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

ROOT = Path(__file__).resolve().parent.parent


def test_bigvocab_tool_cpu(tmp_path):
    out = tmp_path / "weights"
    cmd = [sys.executable, "-m", "retto_tpu_torch.train.train_bigvocab", "--device", "cpu",
           "--steps", "2", "--data-n", "64", "--batch", "8", "--pipe-pages", "1",
           "--out", str(out)]
    env = dict(os.environ, OMP_NUM_THREADS="2")
    r = subprocess.run(cmd, cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]
    assert "[big] 6625 classes" in r.stdout and "[big] step 1: loss" in r.stdout
    assert "pipeline crops" in r.stdout and "non-finite losses: 0 of 2" in r.stdout
    assert "steps_per_s" in r.stdout and "exact-sequence match on 256" in r.stdout
    assert (tmp_path / "synth_cache" / "big_lines.npz").exists()
    ckpt = out / "rec_big.npz"
    assert len((out / "charset_big.txt").read_text(encoding="utf-8").splitlines()) == 6623

    from retto_tpu.weights import load_params_meta as j_load
    from retto_tpu_torch.models import build_rec
    from retto_tpu_torch.weights import load_flax_params, load_params_meta

    tree, meta = j_load(ckpt)
    assert meta["preset"] == "mobile"
    assert tree["params"]["Dense_1"]["kernel"].shape[-1] == 6625
    flat, _ = load_params_meta(ckpt)
    model = load_flax_params(build_rec("mobile", num_classes=6625, compute_dtype="bfloat16"),
                             flat).eval()
    assert all(np.isfinite(p.detach().numpy()).all() for p in model.parameters())
    # the reloaded checkpoint gives the trained model's outputs
    from retto_tpu_torch.train.train_bigvocab import probe_digest

    assert f"[big] probe_digest {probe_digest(model, 'cpu')}" in r.stdout


def test_bigvocab_tool_refuses_shipped_weights_dir():
    from retto_tpu_torch.train import train_bigvocab

    with pytest.raises(SystemExit, match="trained_weights"):
        train_bigvocab.main(["--device", "cpu", "--out", str(ROOT / "trained_weights")])


def test_rendered_lines_match_jax_tool():
    """``render_dataset`` from one seed gives the JAX tool's lines, labels,
    lengths and texts, pixel for pixel."""
    spec = importlib.util.spec_from_file_location("jax_train_bigvocab",
                                                  ROOT / "tools" / "train_bigvocab.py")
    jtool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(jtool)
    from retto_tpu_torch.train.train_bigvocab import render_dataset

    ji, jl, jn, jt = jtool.render_dataset(np.random.default_rng(7), 24)
    ti, tl, tn, tt = render_dataset(np.random.default_rng(7), 24)
    assert jt == tt
    np.testing.assert_array_equal(jl, tl)
    np.testing.assert_array_equal(jn, tn)
    for a, b in zip(ji, ti):
        np.testing.assert_array_equal(a, b)
