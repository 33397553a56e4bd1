"""Fixtures of the benchmark's own tests (``python -m pytest ffsbench/tests``)."""

from __future__ import annotations

import pytest


@pytest.fixture
def card():
    """Skips a test marked ``gpu`` where no CUDA card is present (decided
    here, at run time, never while the module is imported)."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")
