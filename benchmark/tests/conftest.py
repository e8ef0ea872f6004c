"""The benchmark's own tests: ``pytest benchmark/tests``.

Tests marked ``card`` need a CUDA card and skip without one; the card is
looked for inside the ``cuda_device`` fixture, never at import or
collection, so every worker collects the same tests.
"""

import pytest

SMALL = {"width": 48, "height": 40}


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs a CUDA card (skips without one)")


@pytest.fixture
def cuda_device():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("no CUDA card: this test runs on the card")
    return torch.device("cuda", 0)
