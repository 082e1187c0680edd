"""Test set-up: the benchmark's folder and the checkout's root on the path
(as ``benchmark/run.py`` puts them), and the ``card`` fixture of the tests
marked ``gpu``.

    python -m pytest benchmark/tests -q -p no:cacheprovider

runs every test here on the CPU (those marked ``gpu`` skip); on a machine
with a card the ``gpu`` ones run too: ``-m gpu``.
"""

import sys
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(BENCH), str(BENCH.parent)]


@pytest.fixture
def card():
    """The first CUDA device; skips the test without one."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    return torch.device("cuda")
