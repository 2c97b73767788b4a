"""The benchmark's own tests (``python -m pytest portbench/tests``).  The
repo's ``tests/conftest.py`` is not loaded here, so the ``cuda`` marker is
registered again: tests that need the card carry it and decide in a fixture
whether there is one."""

import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def pytest_configure(config):
    config.addinivalue_line("markers", "cuda: needs an NVIDIA card (skips without one)")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: the benchmark's runs on the card")
    return torch.cuda.get_device_name(0)
