"""The port's bitonic row sort (the plain PyTorch versions of the CUDA
kernels in ``csrc/bitonic_sort.cu``) against ``np.sort`` and against
sage_tpu's Pallas kernels in interpret mode, on the CPU: one-pass rows
and the hierarchical path with the block size forced, non-power-of-two
widths, ragged batches, sentinel tails, duplicates and negatives. On
i32 keys every correct sort gives one output, so all must be equal."""

import jax  # noqa: F401  (conftest keeps JAX on the CPU)
import numpy as np
import pytest
import torch

from sage_tpu.ops.pallas_sort import bitonic_sort_rows as jax_sort
from sage_tpu_torch.ops import pallas_sort

SENT = 2**31 - 1


def _keys(kind, B, F, seed):
    rng = np.random.default_rng(seed)
    if kind == "dups":
        return rng.integers(-5, 5, size=(B, F), dtype=np.int32)
    if kind == "sentinel":
        x = rng.integers(-3, 1000, size=(B, F), dtype=np.int32)
        x[:, F * 3 // 4:] = SENT  # the padded tail must stay at the tail
        return x
    return rng.integers(-(2**26), 2**26, size=(B, F), dtype=np.int32)


# (B, F, block, keys): the cases of tests/test_pallas_sort.py
CASES = [
    (8, 128, None, "wide"), (3, 128, None, "wide"), (16, 512, None, "wide"),
    (9, 300, None, "wide"), (8, 200, None, "sentinel"),
    (8, 256, None, "dups"),
    (8, 512, 128, "wide"), (8, 1024, 128, "wide"), (3, 700, 128, "wide"),
    (8, 2048, 256, "wide"), (9, 511, 64, "wide"), (8, 900, 128, "sentinel"),
    (5, 1000, 128, "dups"),
]


@pytest.mark.parametrize("B,F,block,keys", CASES,
                         ids=[f"{b}x{f}-{bl}-{k}" for b, f, bl, k in CASES])
def test_plain_sort_matches_npsort_and_sage_tpu(B, F, block, keys):
    x = _keys(keys, B, F, B * 7919 + F)
    before = dict(pallas_sort.launches)
    got = pallas_sort.bitonic_sort_rows(torch.from_numpy(x), block=block)
    assert got.dtype == torch.int32 and got.shape == (B, F)
    # CPU tensors take the plain versions: no kernel launch is counted
    assert pallas_sort.launches == before
    np.testing.assert_array_equal(got.numpy(), np.sort(x, axis=1))
    want = np.asarray(jax_sort(x, interpret=True, block=block))
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("F", [1, 3, 4096, 40000])
def test_plain_sort_one_pass_limit(F, monkeypatch):
    """Rows up to the card's one-pass limit (2^15) sort in one pass;
    longer rows take the hierarchical path with 2^15-key blocks. The
    block size never changes the output."""
    x = _keys("wide", 2, F, F)
    calls = []
    real = pallas_sort.merge_blocks_plain
    monkeypatch.setattr(pallas_sort, "merge_blocks_plain",
                        lambda v, cb: calls.append(cb) or real(v, cb))
    got = pallas_sort.bitonic_sort_rows(torch.from_numpy(x))
    np.testing.assert_array_equal(got.numpy(), np.sort(x, axis=1))
    assert calls == ([pallas_sort._BLOCK_MAX] if F > pallas_sort._BLOCK_MAX
                     else [])
    small = pallas_sort.bitonic_sort_rows(torch.from_numpy(x), block=256)
    np.testing.assert_array_equal(small.numpy(), got.numpy())


def test_sort_blocks_pads_in_place_of_device_memory():
    """sort_blocks reads the pad key for positions past the row: a
    ragged row sorted block-wise keeps every real key and fills the
    padding with the pad key."""
    x = _keys("wide", 3, 100, 5)
    out = pallas_sort.sort_blocks(torch.from_numpy(x), 64, 128, SENT).numpy()
    assert out.shape == (3, 128)
    for r in range(3):
        np.testing.assert_array_equal(out[r, :64], np.sort(x[r, :64]))
        tail = np.sort(np.concatenate([x[r, 64:], np.full(28, SENT)]))
        np.testing.assert_array_equal(out[r, 64:], tail)


def test_use_pallas_sort_gate():
    assert pallas_sort.use_pallas_sort(pallas_sort.MAX_F, (1 << 25) - 1)
    assert not pallas_sort.use_pallas_sort(pallas_sort.MAX_F + 1, 10)
    assert not pallas_sort.use_pallas_sort(128, 1 << 25)
