"""The benchmark's own tests. CPU tests run everywhere; tests marked
``card`` need a CUDA device and skip without one (decided in the ``card``
fixture, never at import). Run with ``python -m pytest benchmark/tests``
from the repository root."""
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def pytest_configure(config):
    config.addinivalue_line("markers",
                            "card: needs a CUDA device (an NVIDIA H100)")


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device visible: this test runs on the card")
    return torch.device("cuda")


@pytest.fixture(autouse=True)
def _few_threads():
    import torch
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 4))
    yield
    torch.set_num_threads(n)
