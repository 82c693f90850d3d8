"""``python -m retto_tpu_torch.train.synthetic`` end to end on the CPU, in a
subprocess: two steps of the ``tiny`` rec on a small rendered set (one
pipeline-rendered page through the shipped det), and the checkpoint it
writes loads in both packages."""

from __future__ import annotations

import os
import subprocess
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent.parent


def test_synthetic_rec_tiny_cpu(tmp_path):
    out = tmp_path / "weights"
    cmd = [sys.executable, "-m", "retto_tpu_torch.train.synthetic", "rec", "--device", "cpu",
           "--preset", "tiny", "--steps", "2", "--out", str(out),
           "--steps-scale", "0.002", "--batch", "8", "--pipe-pages", "1"]
    env = dict(os.environ, OMP_NUM_THREADS="2")
    r = subprocess.run(cmd, cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]
    assert "[rec] step 1: loss" in r.stdout and "pipeline crops" in r.stdout
    ckpt = out / "rec_tiny.npz"
    assert ckpt.exists() and (out / "charset.txt").exists()
    assert not (ROOT / "trained_weights" / "rec_tiny.npz").exists()

    from retto_tpu.weights import load_params_meta as j_load
    from retto_tpu_torch.models import build_rec
    from retto_tpu_torch.weights import load_flax_params, load_params_meta

    tree, meta = j_load(ckpt)
    assert meta["preset"] == "tiny"
    flat, _ = load_params_meta(ckpt)
    n_cls = flat["params::Dense_1::bias"].shape[0]
    model = load_flax_params(build_rec("bare", num_classes=n_cls, **{
        k: tuple(v) if isinstance(v, list) else v for k, v in meta["overrides"].items()}), flat)
    assert all(np.isfinite(p.detach().numpy()).all() for p in model.parameters())
