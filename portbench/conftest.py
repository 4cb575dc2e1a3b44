"""pytest settings of the benchmark's own tests (``portbench/tests``)."""

import pytest


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs a CUDA card; skipped inside the test when there is none")


@pytest.fixture
def card():
    """The CUDA device; skips the test when this machine has no card."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("no CUDA card on this machine")
    return torch.device("cuda")
