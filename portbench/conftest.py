"""pytest settings of the benchmark's own tests: ``python -m pytest portbench/tests -q``.

Tests that need a CUDA card carry the ``chip`` marker and take the ``cuda_device`` fixture, which skips them
where there is none; on a card: ``python3 -m pytest portbench/tests -q -m chip``.
"""

import pytest


def pytest_configure(config):
    config.addinivalue_line("markers", "chip: needs a CUDA card (skips without one)")


@pytest.fixture
def cuda_device():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: torch.cuda.is_available() is False")
    return torch.device("cuda", 0)
