"""retto_tpu_torch.tools.epilogue_probe: what runs without a card (the
ptxas reader, the byte counts, the fitted line).  The timings run on the
card only (``chip_smoke.py`` phase kernel)."""

from __future__ import annotations

import math

import pytest

from retto_tpu_torch.tools.epilogue_probe import (
    bound_ms,
    epilogue_bytes,
    fit_line,
    main,
    ptxas_resources,
)

_MANGLED = "_ZN12_GLOBAL__N_118db_epilogue_kernelI{}Li{}EEEv14CUtensorMap_stPhS2_iifii"


def _entry(dtype: str, pool: int, regs: int, spill: int = 0) -> str:
    name = _MANGLED.format(dtype, pool)
    return (f"ptxas info    : Compiling entry function '{name}' for 'sm_90a'\n"
            f"ptxas info    : Function properties for {name}\n"
            f"    0 bytes stack frame, {spill} bytes spill stores, {spill} bytes spill loads\n"
            f"ptxas info    : Used {regs} registers, used 1 barriers, 13184 bytes smem, "
            f"528 bytes cmem[0]\n")


def test_ptxas_resources_reads_each_instance():
    log = "ptxas info    : 0 bytes gmem\n" + "".join(
        _entry(d, p, 30 + p, spill=8 if (d, p) == ("f", 1) else 0)
        for d in ("13__nv_bfloat16", "f") for p in (1, 2, 4))
    log += ("ptxas info    : Compiling entry function '_Z5otherPf' for 'sm_90a'\n"
            "ptxas info    : Used 99 registers, 0 bytes smem\n")
    got = ptxas_resources(log)
    assert sorted(got) == ["bf16_pool1", "bf16_pool2", "bf16_pool4",
                           "f32_pool1", "f32_pool2", "f32_pool4"]
    assert got["bf16_pool2"] == {"spill_stores": 0, "spill_loads": 0, "registers": 32,
                                 "smem": 13184}
    assert got["f32_pool1"]["spill_stores"] == 8 and got["f32_pool4"]["registers"] == 34
    assert ptxas_resources("") == {}


def test_epilogue_bytes_at_the_main_and_onnx_shapes():
    # the figures PERF.md's kernel table gives
    assert epilogue_bytes((4, 512, 384), 2, 2) == 1_867_776
    assert epilogue_bytes((4, 512, 384), 2, None) == 1_671_168
    assert epilogue_bytes((1, 512, 384), 2, None) == 417_792
    assert epilogue_bytes((4, 1024, 768), 4, 4) == 13_172_736
    assert bound_ms(1_867_776) == pytest.approx(0.000558, abs=5e-7)


def test_fit_line_recovers_intercept_and_rate():
    rate = 2.5e12
    pts = [(n, 0.0015 + n / rate * 1e3) for n in (466_944, 1_867_776, 7_471_104)]
    fixed, got = fit_line(pts)
    assert fixed == pytest.approx(0.0015, rel=1e-9)
    assert got == pytest.approx(rate, rel=1e-9)
    assert fit_line([(1, 2.0), (2, 2.0), (3, 1.0)])[1] == math.inf


def test_main_needs_a_card(monkeypatch):
    monkeypatch.setattr("torch.cuda.is_available", lambda: False)
    with pytest.raises(SystemExit):
        main([])
