"""Fixtures of the benchmark's tests: imports from the checkout, and the
environment that ``run.use_checkout`` writes restored after each test."""
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
for p in (str(ROOT), str(ROOT / "src")):
    if p not in sys.path:
        sys.path.insert(0, p)

CACHE_VARS = ("TRITON_CACHE_DIR", "TORCH_EXTENSIONS_DIR", "TORCHINDUCTOR_CACHE_DIR",
              "CUDA_CACHE_PATH")


@pytest.fixture
def checkout_env(monkeypatch):
    """Lets a test call ``run.main``: the cache variables it sets are put
    back at teardown."""
    for var in CACHE_VARS:
        monkeypatch.setenv(var, "unset-by-test")
    return monkeypatch


@pytest.fixture
def card():
    """Skips where there is no CUDA card (decided when the test runs)."""
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: run on the chip")
    return torch.device("cuda")
