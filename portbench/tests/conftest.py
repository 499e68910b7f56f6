"""Fixtures of the benchmark's own tests (``python -m pytest
portbench/tests``). Tests that need the card take ``cuda_device``,
which decides at the test whether a card is there."""

import pytest


@pytest.fixture
def cuda_device():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the system under test's kernels "
                    "run only on the card")
    return torch.device("cuda:0")
