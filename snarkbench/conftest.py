"""pytest settings of the benchmark's own tests (``snarkbench/tests``):

    python -m pytest snarkbench/tests -q -n 4

The ``card`` marker is for tests that need a CUDA card; they decide in the
``card`` fixture whether one is there and skip where it is not. Run them on
the card with ``python -m pytest snarkbench/tests -m card -q -o addopts=''``
(the repository's settings ask for xdist workers).
"""

import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs a CUDA card (skips without one)")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("no CUDA card: torch.cuda.is_available() is false")
    return torch.device("cuda")
