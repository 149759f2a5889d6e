"""The port's device-time meter (``utils/devprof.py``).

On CPU tensors ``amortized_exec_s`` returns a finite time >= 0, timed by
the host's clock. On the card (``gpu`` marker) it times with CUDA
events.
"""

import math

import pytest
import torch

from sage_tpu_torch.utils import devprof


def _ok(t):
    return math.isfinite(t) and t >= 0.0


def test_cpu_functions_return_finite_times():
    x = torch.rand((256, 256))
    assert _ok(devprof.amortized_exec_s(lambda: [x @ x, (x + 1,)], reps=3))


def test_amortized_needs_a_tensor():
    with pytest.raises(ValueError, match="no tensor"):
        devprof.amortized_exec_s(lambda: None, reps=1)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.gpu
def test_card_functions_time_with_events(cuda):
    x = torch.rand((2048, 2048), device=cuda)
    t = devprof.amortized_exec_s(lambda: x @ x, reps=5)
    assert _ok(t) and t > 0
