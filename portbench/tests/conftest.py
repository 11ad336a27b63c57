"""The benchmark's own tests. Tests that need an NVIDIA card carry the `card`
marker and skip without one (decided inside the test's fixture, never at
import). Run them all from the checkout's root:

    python -m pytest portbench/tests -q              # here: the card tests skip
    python -m pytest portbench/tests -q -m card      # on a machine with the card
"""

import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs an NVIDIA card (CUDA); skips without one")


@pytest.fixture
def card():
    """The CUDA device, or a skip where there is none."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: this test runs the benchmark on the card")
    return torch.device("cuda", 0)
