"""Test set-up for the benchmark's own tests: the harness, the reference,
these tests and the program importable; the card-only tests skip without
one (decided inside the fixture)."""

import sys
from pathlib import Path

import pytest

HERE = Path(__file__).resolve().parent
for p in (HERE, HERE.parent, HERE.parent.parent):
    if str(p) not in sys.path:
        sys.path.insert(0, str(p))


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the benchmark runs only on one")
    return torch.device("cuda:0")
