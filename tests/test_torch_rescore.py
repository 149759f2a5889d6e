"""The candidate rescore of the PyTorch port against sage_tpu on the CPU.

``sage_tpu_torch.ops.rescore.rescore_candidate_plain`` (the plain
version, which CPU tensors take) against
``sage_tpu.ops.search.rescore_candidate`` vmapped twice over [n, k] as
the fused stage 2 runs it, on the same numpy inputs: integers equal and
f32 outputs equal as bits. The wrapper's CUDA kernel is held against the
plain version in tests/test_torch_gpu.py."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import sage_tpu.chem.mass as jmass
import sage_tpu.ops.search as jsearch
from sage_tpu_torch.ops import rescore as trescore

from _rescore_cases import (RANDOM, SERIES, TOLS, crafted_cases, random_case,
                            shape_case)

CRAFTED = crafted_cases()
NAMES = ("mb", "my", "summed_b", "summed_y", "ppm_sum", "longest_b",
         "longest_y")


def _jax(case, jit=True):
    """sage_tpu's rescore_candidate, vmapped over items then rows as the
    fused stage 2 runs it; jitted with XLA's algebraic simplifier off, or
    op by op with ``jit=False``. The simplifier turns a division by a
    constant into a multiply by its reciprocal (on the CPU ``f / 3`` then
    differs from the IEEE division for many values), which is not the op
    order the function writes and the reference engine computes;
    ``test_reference_modes_agree`` holds the two modes equal."""
    tol = jmass.Tolerance(*case["frag_tol"])

    def per_item(f, pkm, pki, mz):
        return jsearch.rescore_candidate(
            f, None, pkm, pki, mz, series=case["series"], frag_tol=tol,
            Z=case["Z"])

    fn = jax.vmap(jax.vmap(per_item, in_axes=(0, None, None, 0)))
    args = [jnp.asarray(case[k]) for k in ("f", "pkm", "pki", "maxz")]
    if jit:
        fn = jax.jit(fn).lower(*args).compile(
            compiler_options={"xla_disable_hlo_passes": "algsimp"})
    return [np.asarray(o) for o in fn(*args)]


def _torch(case, fn=trescore.rescore_candidate_plain, device="cpu"):
    args = [torch.from_numpy(case[k]).to(device)
            for k in ("f", "pkm", "pki", "maxz")]
    outs = fn(*args, series=case["series"], frag_tol=case["frag_tol"],
              Z=case["Z"])
    return [o.cpu().numpy() for o in outs]


def _assert_bits(got, want):
    n, k = want[0].shape if want[0].ndim == 2 else (0, 0)
    for name, g, w in zip(NAMES, got, want):
        assert g.shape == w.shape, (name, g.shape, w.shape)
        if name in ("summed_b", "summed_y", "ppm_sum"):
            assert g.dtype == np.float32
            np.testing.assert_array_equal(
                g.view(np.int32), np.asarray(w, np.float32).view(np.int32),
                err_msg=name)
        else:
            assert g.dtype == np.int32
            np.testing.assert_array_equal(g, w, err_msg=name)
    return n, k


@pytest.mark.parametrize(
    "series,L,Pk,Z,tol,n,k", RANDOM,
    ids=[f"{''.join(s)}-L{L}-Pk{P}-Z{Z}-{t}" for s, L, P, Z, t, _n, _k
         in RANDOM])
def test_plain_matches_sage_tpu_random(series, L, Pk, Z, tol, n, k):
    case = shape_case((series, L, Pk, Z, tol, n, k))
    got = _torch(case)
    _assert_bits(got, _jax(case))
    # the inputs reach every branch: matches, unmatched slots, maxz 0-4
    assert got[0].sum() + got[1].sum() > 0
    assert set(np.unique(case["maxz"])) >= set(range(min(Z + 2, 4)))


def test_reference_modes_agree():
    """The jitted reference (algebraic simplifier off) equals sage_tpu's
    function run op by op, at fragment charge 3 where a reciprocal
    multiply would differ."""
    case = random_case(11, 3, 3, SERIES[1], 7, 17, 3, TOLS["ppm"])
    want = _jax(case, jit=False)
    _assert_bits(_jax(case), want)
    _assert_bits(_torch(case), want)


@pytest.mark.parametrize("name", sorted(n for n in CRAFTED
                                        if not n.startswith("no_")))
def test_plain_matches_sage_tpu_crafted(name):
    case = CRAFTED[name]
    got = _torch(case)
    _assert_bits(got, _jax(case))
    if name == "equal_intensities":
        # the greatest mass among the equal intensities: a nonzero ppm
        # term where the first index would give 0
        assert got[4][0, 0] > 0
    if name == "all_pads":
        assert not any(o.any() for o in got)


@pytest.mark.parametrize("name", ["no_rows", "no_items"])
def test_empty_grid(name):
    """n * k == 0: empty [n, k] outputs of the plain version's dtypes,
    from the plain version and from the wrapper (which launches
    nothing)."""
    case = CRAFTED[name]
    shape = case["maxz"].shape
    trescore.launches = 0
    for fn in (trescore.rescore_candidate_plain, trescore.rescore_candidate):
        got = _torch(case, fn)
        assert [o.shape for o in got] == [shape] * 7
        assert [o.dtype for o in got] == [np.int32] * 2 + [np.float32] * 3 \
            + [np.int32] * 2
    assert trescore.launches == 0


def test_wrapper_takes_plain_on_cpu():
    case = random_case(3, 4, 5, SERIES[2], 9, 17, 3, TOLS["ppm"])
    trescore.launches = 0
    got = _torch(case, trescore.rescore_candidate)
    assert trescore.launches == 0
    _assert_bits(got, _torch(case))


def test_wrapper_refuses_other_devices():
    case = random_case(4, 2, 3, SERIES[1], 7, 8, 2, TOLS["da"])
    with pytest.raises(ValueError, match="unsupported device"):
        _torch(case, trescore.rescore_candidate, device="meta")


def test_search_resolves_the_wrapper():
    """Both callers reach the kernel's wrapper: the Scorer through
    ``ops.search``'s namespace, the grid through its import."""
    import sage_tpu_torch.ops.search as tsearch
    from sage_tpu_torch.parallel import sharding

    assert tsearch.rescore_candidate is trescore.rescore_candidate
    assert sharding.rescore_candidate is trescore.rescore_candidate


@pytest.mark.parametrize("S", [1, 2, 3])
def test_run_automaton_matches_vec(S):
    """The kernel runs the Run automaton for every terminus; for one
    series the plain version takes ``longest_run_vec``. The two agree,
    and chaining series equals the automaton over their concatenation."""
    rng = np.random.default_rng(S)
    L = 12
    flags = torch.from_numpy(rng.random((400, S * L)) < 0.6)
    idx = torch.arange(L, dtype=torch.int32).repeat(S)
    scan = trescore.longest_run_scan(flags, idx)
    if S == 1:
        vec = trescore.longest_run_vec(flags, torch.arange(L,
                                                           dtype=torch.int32))
        assert torch.equal(scan, vec)
    for r in range(0, 400, 37):
        start = length = last = longest = 0
        for t in range(S * L):
            l = int(idx[t])
            if not flags[r, t] or last == l:
                continue
            if start + length == l:
                length += 1
            else:
                start, length = l, 1
            longest = max(longest, length)
            last = l
        assert int(scan[r]) == longest
