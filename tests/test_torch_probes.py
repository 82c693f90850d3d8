"""The port's device probes (``python -m retto_tpu_torch.tools.{stage_probe,
det_probe,clsrec_probe}``) on the CPU at tiny sizes: each ``main(argv)``
runs with ``--device cpu`` (the stage and cls + rec probes on the tiny
checkpoints of tests/torch_tiny_ckpt.py, the det probe on random weights
as the JAX tool), every row's label is one of the JAX tool's (each label's
fixed text is read in that tool's source) or a named addition of the port,
every time is finite and positive, and FLOPs are positive where the JAX
tool prints them."""

from __future__ import annotations

import math
import re
from pathlib import Path

import pytest

from torch_tiny_ckpt import write_tiny_checkpoints

ROOT = Path(__file__).resolve().parent.parent

# the fixed text of each label the JAX tool prints (tools/<name>.py)
JAX_LABELS = {
    "stage_probe": ["upload ", "det_fwd (resize+det+binarize, batch ", "mask fetch ",
                    "score_fwd (64 cands)", "clsrec_fwd (", "clsrec fetch"],
    "det_probe": ["mobile tpu-bb s", "mobile tpu-bb full-res contract",
                  "mobilenetv3-bb x0.5 s2 raw", "tpu-bb s1 (full-res head)",
                  "det_fwd gray fused (resize+fwd+pack+pool, batch ",
                  "full det raw, batch 16", "backbone only (batch ", "fpn only",
                  "head only (incl. bilinear logit upsample)",
                  "backbone, bf16 NHWC input (batch ", "backbone 2x widths (batch "],
    "det_probe_v2": ["v2-lean w(128,256,384) d(1,1,1)", "v2-mid w(128,256,384) d(2,2,2)",
                     "v2-wide w(256,384,512) d(1,2,2)"],
    "clsrec_probe": ["clsrec_fwd full (n=", "clsrec_fwd rec-only (n=", "sym=OFF",
                     "cls fwd alone (n=", "rec fwd alone (n=", "rec fwd + ctc (n=",
                     "separable warp rec 48x320 (n=", "separable warp cls 48x192 (n="],
}
# the port's additions: the call's wall time, and the host postprocess the
# port runs per chunk where JAX scores on the device
PORT_LABELS = {"stage_probe": ["run_many (", "det_chunk host postprocess ("]}


@pytest.fixture(scope="module")
def tiny(tmp_path_factory) -> str:
    d = tmp_path_factory.mktemp("probe_ckpt")
    write_tiny_checkpoints(d)
    return str(d)


def _check(tool: str, rows, jax_key: str | None = None) -> None:
    src = (ROOT / "tools" / f"{tool}.py").read_text()
    want = JAX_LABELS[jax_key or tool]
    for text in want:
        assert text in src, f"{text!r} is not in tools/{tool}.py"
        assert any(text in r.label for r in rows), f"no row for {text!r}"
    known = want + PORT_LABELS.get(tool, [])
    for r in rows:
        assert any(r.label.startswith(t) or t in r.label for t in known), r.label
        assert math.isfinite(r.ms) and r.ms > 0, r
        assert math.isfinite(r.median_ms) and r.median_ms >= r.ms, r


def test_stage_probe_cpu(tiny, capsys):
    from retto_tpu_torch.tools import stage_probe

    rows = stage_probe.main(["--device", "cpu", "--weights", tiny, "--pages", "2",
                             "--chunk", "1", "--size", "192x160", "--iters", "1",
                             "--crops", "2", "--width", "320"])
    _check("stage_probe", rows)
    out = capsys.readouterr().out
    gflop = float(re.search(r"det model flops \(batch 1\): ([0-9.]+) GFLOP", out).group(1))
    assert gflop > 0
    assert "device stages of one call" in out
    det = [r for r in rows if r.label.startswith("det_fwd")]
    assert det and all(r.flops > 0 and r.per_call >= 1 for r in det)


def test_det_probe_cpu():
    from retto_tpu_torch.tools import det_probe

    rows = det_probe.main(["--device", "cpu", "--batch", "1", "--h", "64", "--w", "64",
                           "--iters", "1", "--variants", "--submodules"])
    _check("det_probe", rows)
    # the JAX tool prints FLOPs for every model row, not for the fused det_fwd
    assert all(r.flops > 0 for r in rows if not r.label.startswith("det_fwd")), rows
    v2 = det_probe.main(["--device", "cpu", "--batch", "1", "--h", "64", "--w", "64",
                         "--iters", "1", "--v2"])
    _check("det_probe", v2, "det_probe_v2")
    assert len(v2) == 6 and all(r.flops > 0 for r in v2)


def test_clsrec_probe_cpu(tiny):
    from retto_tpu_torch.tools import clsrec_probe

    rows = clsrec_probe.main(["--device", "cpu", "--weights", tiny, "--n", "2",
                              "--iters", "1"])
    _check("clsrec_probe", rows)
    assert len(rows) == 8
