"""The port's row sort (the plain PyTorch versions of the CUDA kernels in
``csrc/row_sort.cu`` and ``csrc/cluster_sort.cu``) against ``np.sort``
and against sage_tpu's Pallas kernels in interpret mode, on the CPU:
one-pass rows and the cluster path, with its slice size forced so that
small rows take 2-8 slices, non-power-of-two widths, ragged batches,
sentinel tails, duplicates and negatives, the full int32 range, and the
open search's packed keys. On i32 keys every correct sort gives one
output, so all must be equal."""

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


def _spy_slices(monkeypatch):
    """Record the slice count of every call of the cluster kernel's plain
    version."""
    calls = []
    real = pallas_sort.cluster_sort_plain

    def spy(v, block=None):
        calls.append(pallas_sort.cluster_shape(v.shape[1], block)[0])
        return real(v, block)

    monkeypatch.setattr(pallas_sort, "cluster_sort_plain", spy)
    return calls


@pytest.mark.parametrize("F", [1, 3, 4096, 40000])
def test_plain_sort_one_pass_limit(F, monkeypatch):
    """Rows up to the card's one-pass limit (2^15) sort in one pass;
    longer rows take the cluster kernel's plain version, in slices of
    2^14 keys (3 at F = 40,000). The slice size never changes the
    output."""
    x = _keys("wide", 2, F, F)
    calls = _spy_slices(monkeypatch)
    got = pallas_sort.bitonic_sort_rows(torch.from_numpy(x))
    np.testing.assert_array_equal(got.numpy(), np.sort(x, axis=1))
    assert calls == ([3] if F > pallas_sort._BLOCK_MAX else [])
    small = pallas_sort.bitonic_sort_rows(torch.from_numpy(x), block=256)
    np.testing.assert_array_equal(small.numpy(), got.numpy())


def test_use_pallas_sort_gate():
    assert pallas_sort.use_pallas_sort(pallas_sort.MAX_F, (1 << 25) - 1)
    assert not pallas_sort.use_pallas_sort(pallas_sort.MAX_F + 1, 10)
    assert not pallas_sort.use_pallas_sort(128, 1 << 25)


INT32_MIN = -(2**31)


def _radix_keys(kind, B, F, seed):
    """Rows for the radix sort's digit passes: the full int32 range (its
    landmarks INT32_MIN, -1, 0, INT32_MAX in every row), all-equal rows
    (every pass skipped), sorted and reverse-sorted rows, the open
    search's packed keys ((2^25 - pep) << 5) | z of one band with
    INT32_MAX invalid entries among them and as a tail, and rows where
    INT32_MAX ties other keys on their low digits."""
    rng = np.random.default_rng(seed)
    wide = rng.integers(INT32_MIN, 2**31, size=(B, F), dtype=np.int64)
    if kind == "int32_range":
        x = wide.astype(np.int32)
        marks = np.array([INT32_MIN, -1, 0, SENT], np.int32)
        for r in range(B):
            at = rng.choice(F, size=min(F, 4), replace=False)
            x[r, at] = marks[: at.size]
        return x
    if kind == "equal":
        return np.full((B, F), rng.integers(INT32_MIN, 2**31), np.int32)
    if kind == "sorted":
        return np.sort(wide.astype(np.int32), axis=1)
    if kind == "reversed":
        return np.sort(wide.astype(np.int32), axis=1)[:, ::-1].copy()
    if kind == "ties":
        return _tie_keys(B, F, rng)
    assert kind == "open"
    pep = rng.integers(40_000, 40_000 + 3_000, size=(B, F))
    z = rng.integers(1, 4, size=(B, F))
    x = (((2**25 - pep) << 5) | z).astype(np.int32)
    x[rng.random((B, F)) < 0.8] = SENT  # invalid entries, as in the open rows
    for r in range(B):
        x[r, int(rng.integers(0, F + 1)):] = SENT
    return x


def _tie_keys(B, F, rng):
    """Rows where INT32_MAX shares its low digits with other keys, so a
    pass skipped over the others must still put it last: odd rows repeat
    [INT32_MAX, 255, 0]; even rows hold INT32_MAX entries, then open keys
    2^25 - pep of peptides 1-3 at Z = 1 (2^25 - 1 ends in three 0xFF
    digits)."""
    x = np.tile(np.array([SENT, 255, 0], np.int32), (B, F // 3 + 1))[:, :F]
    x = np.ascontiguousarray(x)
    h = F // 2
    x[1::2, :h] = SENT
    x[1::2, h:] = 2**25 - rng.integers(1, 4, size=(len(x[1::2]), F - h))
    return x


RADIX_KINDS = ["int32_range", "equal", "sorted", "reversed", "open", "ties"]
# F = 1, and widths just off a digit (256 bins), a warp's keys and the
# kernel's thread count (1024)
RADIX_WIDTHS = [1, 255, 257, 1023, 1025]


@pytest.mark.parametrize("F", RADIX_WIDTHS)
@pytest.mark.parametrize("kind", RADIX_KINDS)
def test_radix_plain_matches_npsort_and_sage_tpu(kind, F):
    """The radix kernel's plain version (sign flip, 8-bit LSD passes,
    stable counting scatter) is bit-equal to np.sort and to sage_tpu's
    interpret-mode bitonic kernel; bitonic_sort_rows takes it for a
    one-pass row."""
    x = _radix_keys(kind, 3, F, RADIX_KINDS.index(kind) * 131 + F)
    got = pallas_sort.sort_rows_plain(torch.from_numpy(x))
    assert got.dtype == torch.int32 and got.shape == x.shape
    np.testing.assert_array_equal(got.numpy(), np.sort(x, axis=1))
    want = np.asarray(jax_sort(x, interpret=True))
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(
        pallas_sort.bitonic_sort_rows(torch.from_numpy(x)).numpy(), want)

# widths past the one-pass limit: just past it, and the cluster sizes the
# kernel picks (3, 4, 5 and 8 slices of up to 2^14 keys)
CLUSTER_WIDTHS = [32769, 40000, 65536, 70000, 131072]


@pytest.mark.parametrize("F", CLUSTER_WIDTHS)
@pytest.mark.parametrize("kind", RADIX_KINDS + ["all_pad"])
def test_cluster_plain_matches_npsort_and_sage_tpu(kind, F, monkeypatch):
    """The cluster kernel's plain version (dealt slices, real-key count,
    digit passes with cross-slice offsets, INT32_MAX tail) on every key
    kind and on rows of INT32_MAX only: bit-equal to np.sort, and at
    F <= 40,000 to sage_tpu's interpret-mode hierarchical sort;
    bitonic_sort_rows takes it for these rows."""
    if kind == "all_pad":
        x = np.full((2, F), SENT, np.int32)
    else:
        x = _radix_keys(kind, 2, F, RADIX_KINDS.index(kind) * 17 + F)
    got = pallas_sort.cluster_sort_plain(torch.from_numpy(x))
    assert got.dtype == torch.int32 and got.shape == x.shape
    np.testing.assert_array_equal(got.numpy(), np.sort(x, axis=1))
    calls = _spy_slices(monkeypatch)
    via = pallas_sort.bitonic_sort_rows(torch.from_numpy(x))
    assert calls == [-(-F // 2**14)]
    np.testing.assert_array_equal(via.numpy(), got.numpy())
    if F <= 40000:
        want = np.asarray(jax_sort(x, interpret=True))
        np.testing.assert_array_equal(got.numpy(), want)


SLICES = [2, 3, 5, 8]


@pytest.mark.parametrize("slices", SLICES)
@pytest.mark.parametrize("B,F,block,keys", CASES,
                         ids=[f"{b}x{f}-{bl}-{k}" for b, f, bl, k in CASES])
def test_cluster_plain_forced_slices(B, F, block, keys, slices, monkeypatch):
    """The cases above with the slice size forced so that each row takes
    2-8 slices: the cross-slice offsets at small widths; equal to
    np.sort."""
    x = _keys(keys, B, F, B * 7919 + F + slices)
    block = -(-F // slices)
    calls = _spy_slices(monkeypatch)
    got = pallas_sort.bitonic_sort_rows(torch.from_numpy(x), block=block)
    assert len(calls) == 1 and 2 <= calls[0] <= 8
    np.testing.assert_array_equal(got.numpy(), np.sort(x, axis=1))


@pytest.mark.parametrize("kind", RADIX_KINDS)
def test_cluster_plain_forced_slices_key_kinds(kind, monkeypatch):
    """Every radix key kind at 3,000 keys a row with the one-pass limit
    forced to 1,024 (3 slices): equal to np.sort."""
    x = _radix_keys(kind, 2, 3000, 7)
    calls = _spy_slices(monkeypatch)
    got = pallas_sort.bitonic_sort_rows(torch.from_numpy(x), block=1024)
    assert calls == [3]
    np.testing.assert_array_equal(got.numpy(), np.sort(x, axis=1))
