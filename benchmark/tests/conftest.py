"""The benchmark's CPU tests (``python -m pytest benchmark/tests``), apart
from the repository's ``tests/``. ``card`` marks a test that needs a CUDA
card; it skips without one, deciding inside its fixture."""

import pytest


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs a CUDA card (skips without one)")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.fixture(scope="session")
def tiny_root(tmp_path_factory):
    from benchmark.tests import tiny

    root = tmp_path_factory.mktemp("tiny")
    tiny.make_root(str(root))
    return str(root)
