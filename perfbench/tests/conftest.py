"""The benchmark's CPU tests: the fixture that decides at run time whether
there is a card."""

from __future__ import annotations

import pytest

import perfbench_tiny  # noqa: F401  (puts the checkout's root on sys.path)


@pytest.fixture
def cuda():
    """Skips the test where torch sees no CUDA device (decided here, at run
    time, never at import)."""
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)
