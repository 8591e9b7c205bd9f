"""pytest settings of the benchmark's own tests (python -m pytest
renderbench).  Tests marked `card` need a CUDA card: each decides inside
itself, with require_card(), and skips on a machine without one."""

import pytest


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs a CUDA card; skips inside the test without "
        "one")


def require_card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (torch.cuda.is_available() is False)")
