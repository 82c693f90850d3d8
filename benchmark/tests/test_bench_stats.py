import pytest

from benchmark.stats import rate


def test_rate():
    assert rate(300, 1.5) == 200.0
    with pytest.raises(ValueError):
        rate(1, 0.0)
