"""Settings of the benchmark's own tests (CPU; a test that needs the card is
marked ``cuda`` and skips without one).  Run from the repository root:

    python -m pytest -q -p no:cacheprovider benchmark/tests
"""

import json
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def pytest_configure(config):
    config.addinivalue_line(
        "markers",
        "cuda: needs an NVIDIA GPU (runs the benchmark on the card)")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the benchmark runs the port's "
                    "CUDA kernels")


@pytest.fixture(scope="session")
def spec():
    return json.loads((ROOT / "BENCHMARK.json").read_text())
