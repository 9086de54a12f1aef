"""The port's ``normalize_text`` and helpers (a copy of the JAX package's
host code) on the golden cases of ``tests/test_normalize.py``, and both
packages' ``normalize_text`` over the same inputs."""

import pytest

from tensorflowasr_tpu.utils import normalize as jnorm
from tensorflowasr_tpu_torch.utils.normalize import (
    digits_readout,
    int_to_hanzi,
    normalize_text,
    number_to_hanzi,
    to_halfwidth,
)
from tests.test_normalize import (
    test_int_to_hanzi as _int_cases,
    test_liang_alternation as _liang_cases,
    test_normalize_text as _text_cases,
)


def _params(test):
    """The argument tuples of one of tests/test_normalize.py's
    parametrised tests."""
    return [tuple(m.args[1]) for m in test.pytestmark
            if m.name == "parametrize"][0]


INT_CASES = _params(_int_cases)
LIANG_CASES = _params(_liang_cases)
TEXT_CASES = _params(_text_cases)


@pytest.mark.parametrize("n,want", INT_CASES)
def test_int_to_hanzi(n, want):
    assert int_to_hanzi(n) == want


@pytest.mark.parametrize("num,want", LIANG_CASES)
def test_liang_alternation(num, want):
    assert number_to_hanzi(num, alt_two=True) == want


def test_number_and_digits():
    assert number_to_hanzi("3.5") == "三点五"
    assert number_to_hanzi("-2") == "负二"
    assert number_to_hanzi("0.05") == "零点零五"
    assert digits_readout("10086") == "幺零零八六"
    assert digits_readout("2021", telephone=False) == "二零二一"


def test_to_halfwidth():
    assert to_halfwidth("ＡＢＣ１２３") == "ABC123"
    assert to_halfwidth("，。") == "，。"


@pytest.mark.parametrize("text,want", TEXT_CASES)
def test_normalize_text(text, want):
    assert normalize_text(text) == want


def test_both_packages_normalize_alike():
    texts = [text for text, _ in TEXT_CASES] + [
        "ＡＢＣ１２３", "，。", "2021年5月1日下午3:45在B二C平台花了1,200元"]
    assert len(TEXT_CASES) > 30
    for text in texts:
        assert normalize_text(text) == jnorm.normalize_text(text), text
    for num in ("200", "3.5", "-2", "10200", "123456789"):
        assert number_to_hanzi(num, alt_two=True) == \
            jnorm.number_to_hanzi(num, alt_two=True)
