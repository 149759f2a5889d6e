"""Settings for the benchmark's own tests: the ``gpu`` marker (tests
that need a CUDA device decide inside a fixture and skip without one)."""

import pytest


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: needs a CUDA device; skips where there is none")


@pytest.fixture
def cuda_device():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    return "cuda"


@pytest.fixture(scope="session")
def runner_root(tmp_path_factory):
    """A root whose ``BENCHMARK.json`` has the Runner cells (``_small``)."""
    from _small import runner_root as make

    return make(tmp_path_factory.mktemp("runner-root"))
