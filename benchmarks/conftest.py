"""Tests of the benchmark (benchmarks/tests/). ``card`` marks a test that
needs a CUDA card; the ``card`` fixture decides, when the test runs,
whether there is one, and skips the test with a reason where there is
not. Run them all, on the card or here:

    python -m pytest benchmarks/tests -q
"""

import pytest


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs a CUDA card (skips without one)")


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; the CPU rehearsal covers the rest")
