import json

import pytest

from benchmark import run as R
from benchmark.flops import PEAKS, FlopCounter, epilogue_bytes, peaks_of


def _counter(name: str) -> FlopCounter:
    cfg = json.loads((R.HERE / "configs" / f"{name}.json").read_text())
    return FlopCounter(cfg, R.ROOT)


def test_epilogue_bytes_counts_each_byte_once():
    # [512, 384] bf16 logits read, [64, 384] packed mask and [256, 192]
    # pooled map written
    assert epilogue_bytes(512, 384, 2, 2) == 512 * 384 * 2 + 64 * 384 + 256 * 192 == 466_944
    assert 4 * epilogue_bytes(512, 384, 2, 2) == 1_867_776


def test_cls_flops_match_the_convs_by_hand():
    fc = _counter("mobile")
    # space-to-depth 4 -> [48, 12, 48]; 3x3 convs 48->128, 128->256 (s2),
    # 256->256, 256->256 (s2); dense 256->2; two views (symmetrized)
    one = (2 * 48 * 9 * 128 * 12 * 48 + 2 * 128 * 9 * 256 * 6 * 24
           + 2 * 256 * 9 * 256 * 6 * 24 + 2 * 256 * 9 * 256 * 3 * 12 + 2 * 256 * 2)
    assert fc.cls_flops(192) == pytest.approx(2 * one)
    assert fc.cls_flops(96) == pytest.approx(one)


def test_det_flops_scale_with_area_and_rec_with_width():
    fc = _counter("mobile")
    assert fc.det_flops(512, 384) == pytest.approx(4 * fc.det_flops(256, 192), rel=0.02)
    assert fc.rec_flops(320) > fc.rec_flops(160) > 0
    server = _counter("server")
    assert server.det_flops(992, 736) > 2 * fc.det_flops(992, 736)


def test_crop_widths_of_a_box():
    fc = _counter("mobile")
    box = [[10, 20], [210, 20], [210, 60], [10, 60]]  # 200 x 40
    assert fc.crop_widths(box) == (192, 240)


def test_peaks_fail_on_an_unknown_card():
    assert peaks_of("NVIDIA H100 80GB HBM3") == PEAKS["NVIDIA H100 80GB HBM3"]
    with pytest.raises(KeyError):
        peaks_of("NVIDIA A100-SXM4-80GB")
