"""The benchmark's own tests: `python -m pytest benchmark/tests`. Those
marked `cuda` need the card and skip without it (decided in the `card`
fixture, never at import)."""

import pytest


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA card; skips without one")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    return torch.device("cuda")
