"""The port's device-time meter (``utils/devprof.py``).

On CPU tensors every function returns a finite time >= 0, timed by the
host's clock, and ``chained_exec_s`` of a step whose work grows with a
known size grows with it. On the card (``gpu`` marker) the same
functions time with CUDA events.
"""

import math

import pytest
import torch

from sage_tpu_torch.utils import devprof


def _ok(t):
    return math.isfinite(t) and t >= 0.0


def _matmul_step(n, device):
    """A chain step over an n x n matmul: the chain scalar is folded into
    one input with weight 0 and the next one derived from the output."""
    g = torch.Generator().manual_seed(n)
    a = torch.rand((n, n), generator=g).to(device)

    def step(c):
        x = a + c.to(a.dtype) * 0
        y = x @ x
        return (y[0, :1] * 0).to(torch.int32) + c

    return step


def test_cpu_functions_return_finite_times():
    x = torch.rand((256, 256))
    assert _ok(devprof.measure_rtt(device="cpu"))
    assert _ok(devprof.amortized_exec_s(lambda: [x @ x, (x + 1,)], reps=3))
    assert _ok(devprof.transfer_s(x))
    assert _ok(devprof.upload_s(1 << 20, reps=2, device="cpu"))
    assert _ok(devprof.chained_exec_s(_matmul_step(64, "cpu"), device="cpu"))


def test_amortized_needs_a_tensor():
    with pytest.raises(ValueError, match="no tensor"):
        devprof.amortized_exec_s(lambda: None, reps=1)


def test_chained_grows_with_work():
    """A 512 x 512 matmul (134 M multiply-adds) takes longer a step than a
    64 x 64 one (262 K): the slope tracks the work, not the dispatch."""
    small = devprof.chained_exec_s(_matmul_step(64, "cpu"), k1=2, k2=10,
                                   reps=3, device="cpu")
    large = devprof.chained_exec_s(_matmul_step(512, "cpu"), k1=2, k2=10,
                                   reps=3, device="cpu")
    assert _ok(small) and large > small


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.gpu
def test_card_functions_time_with_events(cuda):
    x = torch.rand((2048, 2048), device=cuda)
    assert _ok(devprof.measure_rtt())
    t = devprof.amortized_exec_s(lambda: x @ x, reps=5)
    assert _ok(t) and t > 0
    assert _ok(devprof.transfer_s(x))
    assert _ok(devprof.upload_s(1 << 24, reps=3))
    small = devprof.chained_exec_s(_matmul_step(256, cuda))
    large = devprof.chained_exec_s(_matmul_step(4096, cuda))
    assert _ok(small) and large > small
