import numpy as np
import pytest

from benchmark.traffic.pages import load_mix, make_pool


@pytest.mark.parametrize("mix_name", ["batch16", "dense16"])
def test_pages_are_deterministic_by_seed(mix_name):
    mix = load_mix(mix_name)
    a = make_pool(mix, 2**31 + 17)
    b = make_pool(mix, 2**31 + 17)
    c = make_pool(mix, 2**31 + 18)
    assert all(np.array_equal(x, y) for x, y in zip(a, b))
    assert not all(np.array_equal(x, y) for x, y in zip(a, c))


@pytest.mark.parametrize("mix_name", ["batch16", "dense16"])
def test_pages_follow_the_mix(mix_name):
    mix = load_mix(mix_name)
    lines: list = []
    pool = make_pool(mix, 3, lines=lines)
    assert len(pool) == mix["batch"] * mix["pool_batches"] == len(lines)
    sizes = {tuple(s) for s in mix["pages"]["sizes"]}
    lo_h, hi_h = mix["pages"]["line_height"]
    for page, boxes in zip(pool, lines):
        assert page.dtype == np.uint8 and page.shape[2] == 3
        assert page.shape[:2] in sizes
        assert (page[..., 0] == page[..., 1]).all() and (page[..., 1] == page[..., 2]).all()
        for x0, y0, x1, y1 in boxes:
            assert lo_h <= y1 - y0 <= hi_h
            assert 0 <= x0 < x1 <= page.shape[1] and 0 <= y0 < y1 <= page.shape[0]
            assert page[y0:y1, x0:x1].min() < 128  # ink in every line
    counts = [len(b) for b in lines]
    if mix["pages"]["layout"] == "lines":
        lo, hi = mix["pages"]["lines"]
        assert lo <= min(counts) and max(counts) <= hi
        assert 3.0 <= np.mean(counts) <= 4.0
    else:
        assert 40 <= np.mean(counts) <= 50  # the crops a dense page brings

