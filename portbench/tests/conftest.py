import pytest

from portbench.harness import CACHE_ENV


@pytest.fixture(autouse=True)
def bench_env(monkeypatch, tmp_path):
    """The run's environment (``harness.set_environment``), with the caches
    in the test's own directory, undone after the test."""
    for key in CACHE_ENV:
        monkeypatch.setenv(key, str(tmp_path / key.lower()))
    monkeypatch.setenv("USE_FLAX", "0")


@pytest.fixture
def cuda_device():
    """The first card; skips the test where there is none (decided when
    the test runs, never at import)."""
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card)")
    return torch.device("cuda:0")
