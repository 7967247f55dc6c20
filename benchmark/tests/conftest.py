"""Settings of the benchmark's own tests (run by path:
`python -m pytest benchmark/tests -q`). Tests marked `card` need a CUDA
card and skip without one; whether there is one is decided inside the
`card` fixture, never at import."""
import sys
from pathlib import Path

import pytest

BENCH_DIR = Path(__file__).resolve().parent.parent
sys.path[:0] = [str(BENCH_DIR), str(BENCH_DIR.parent)]


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs a CUDA card; skips without one")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("no CUDA card: the benchmark's runs need one")
    return torch.cuda.get_device_name(0)
