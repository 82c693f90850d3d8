"""BENCHMARK.json against the benchmark contract, and the imports of the
benchmark's own files."""

import ast
import json
import re
from pathlib import Path

import pytest

from benchmark import run as R

BENCH = json.loads((R.ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
FILES = sorted(R.HERE.rglob("*.py"))


def test_keys_and_names():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["benchmark"] and len(BENCH["command"]) <= 32
    assert 1 <= BENCH["run_seconds"] <= 51
    names = [c["name"] for c in BENCH["configs"]]
    cells = [w["name"] for w in BENCH["workloads"]]
    metrics = [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    for group in (names, cells, metrics):
        assert len(group) == len(set(group))
        assert all(NAME.match(n) for n in group)
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert set(m["workloads"]) <= set(cells) if "workloads" in m else True
    for text in ([c["why"] for c in BENCH["configs"]] + [w["why"] for w in BENCH["workloads"]]
                 + [m["layer"] for m in BENCH["per_layer"]]):
        assert 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_cells_configs_and_metrics_resolve():
    configs = {c["name"]: c for c in BENCH["configs"]}
    used = set()
    for w in BENCH["workloads"]:
        assert w["chips"] in (1, 4)
        used.add(w["config"])
        assert NAME.match(w["traffic"])
        assert (R.HERE / "traffic" / f"{w['traffic']}.json").is_file()
        limits = json.loads((R.HERE / "limits" / f"{w['name']}.json").read_text())
        for name, lim in limits["limits"].items():
            lo, hi = limits["readings"][name]["lower"], limits["readings"][name]["upper"]
            assert hi >= 3 * lo and lo < lim < hi
    assert used == set(configs)
    for c in configs.values():
        assert (R.ROOT / c["file"]).is_file() and c["file"].startswith("benchmark/")
        assert c["reduced"] == [] and 1 <= len(c["source"]) <= 200 and "\n" not in c["source"]
        assert json.loads((R.ROOT / c["file"]).read_text())["source"] == c["source"]
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e
        assert (R.HERE / "metrics" / f"{m['name']}.py").is_file()
        if m["unit"] == "%" and ("roofline" in m["name"] or "mfu" in m["name"]):
            assert m["source"] in ("device_trace", "host_clock")


def test_a_full_check_fits_with_24_cells():
    runs = 2 + 14 * 24
    assert runs * (BENCH["run_seconds"] + 60) + 24 * 2 * 90 + 1200 <= 43200


def _imports(path: Path) -> set[str]:
    tree = ast.parse(path.read_text(), str(path))
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            out.add(node.module.split(".")[0])
    return out


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(R.HERE)))
def test_no_jax_and_no_jax_package(path):
    assert not _imports(path) & {"jax", "jaxlib", "flax", "optax", "retto_tpu"}
    if path.parent.name == "reference":
        assert "retto_tpu_torch" not in _imports(path)


def test_no_run_reads_the_jax_side_of_the_repo():
    for path in FILES:
        if path.parent.name == "tests":
            continue
        text = path.read_text()
        assert "bench.py" not in text and "chip_smoke" not in text
        assert not re.search(r"[\"']retto_tpu/", text)
