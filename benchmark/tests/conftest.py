"""Settings of the benchmark's own tests: the ``card`` marker, for tests
that need a CUDA device (run on the card with ``python -m pytest
benchmark/tests -m card``; skipped elsewhere by the ``card`` fixture)."""

import pytest


def pytest_configure(config):
    config.addinivalue_line("markers",
                            "card: needs a CUDA device; skipped without one")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
