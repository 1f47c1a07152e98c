"""The benchmark's tests. ``card`` marks a test that needs a CUDA card: it
decides in its fixture, never at import, and skips without one. Run them all
on the card with ``python3 -m pytest benchmark/tests -q -p no:randomly``."""

import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs a CUDA card; skipped without one")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


@pytest.fixture(autouse=True)
def _few_threads():
    import torch

    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)
