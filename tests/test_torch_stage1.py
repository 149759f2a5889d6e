"""The port's stage 1 (``Scorer._stage1``, the plain PyTorch version on
the CPU) against sage_tpu's ``Scorer._stage1`` (XLA on the CPU) on the
same segment inputs: equal int32 outputs, in both layouts."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import sage_tpu.chem.fasta as jfasta
import sage_tpu.chem.mass as jmass
import sage_tpu.index.builder as jbuilder
import sage_tpu.ops.search as jsearch
import sage_tpu_torch.chem.fasta as tfasta
import sage_tpu_torch.chem.mass as tmass
import sage_tpu_torch.index.builder as tbuilder
import sage_tpu_torch.ops.search as tsearch
from sage_tpu_torch.ops import pallas_stage1

from _rescore_cases import bound_centres, ieee_bounds, on_bound_masses

AA = np.frombuffer(b"ACDEFGHIKLMNPQRSTVWY", dtype=np.uint8)


@pytest.fixture(scope="module")
def dbs():
    rng = np.random.default_rng(17)
    text = "\n".join(
        f">sp|S{i:03d}|S{i}_SYN synthetic\n"
        + AA[rng.integers(0, len(AA), size=200)].tobytes().decode()
        for i in range(40)
    )
    out = []
    for fasta_mod, builder_mod in ((jfasta, jbuilder), (tfasta, tbuilder)):
        params = builder_mod.DatabaseParams()
        out.append(params.build(
            fasta_mod.Fasta.parse(text, params.decoy_tag, True)
        ))
    return out


def _segment(db, W, R, B, Pk, seed):
    """Rows of one segment and their spectra's packed peaks [2, B, Pk]:
    peaks drawn from real ladders (so counts are non-zero and tie often),
    +inf pads, and padding rows with empty windows."""
    rng = np.random.default_rng(seed)
    P = len(db)
    P_pad = max(((P + 2047) // 2048) * 2048, 128)
    b, y = db.table.ladders()
    masses = np.full((B, Pk), np.inf, np.float32)
    intens = np.full((B, Pk), -1.0, np.float32)
    for s in range(B):
        p = int(rng.integers(0, P))
        k = max(int(db.table.lens[p]) - 1, 1)
        m = np.concatenate([b[p, :k], y[p, :k], 2 * y[p, :k] + 1.0])
        m = np.concatenate([m, rng.uniform(150, 2000, 8)]).astype(np.float32)
        n = int(rng.integers(Pk // 3, Pk + 1))  # +inf pads from n on
        m = np.sort(rng.choice(m, size=min(n, m.size), replace=False))
        masses[s, : m.size] = m
        intens[s, : m.size] = rng.uniform(1, 1e4, m.size)
    p0 = rng.integers(0, P - W, R)
    i0 = p0 + rng.integers(0, W // 4 + 1, R)
    i1 = i0 + rng.integers(0, W + 1, R)
    ints = np.stack([
        rng.integers(0, B, R), np.minimum(p0, P_pad - W), i0, i1,
        rng.choice([2, 3, 4], R),
    ]).astype(np.int32)
    ints[:, R - 3:] = np.array([[B + 5], [0], [0], [0], [2]], np.int32)
    return np.stack([masses, intens]), ints


@pytest.mark.parametrize(
    "W,Z,Lc,tol",
    [
        (16, 1, None, ("ppm", -10.0, 10.0)),
        (40, 3, 16, ("ppm", -10.0, 10.0)),
        (48, 2, 24, ("da", -0.05, 0.05)),
        (64, 3, None, ("ppm", -20.0, 20.0)),
        (128, 2, 12, ("da", -0.02, 0.03)),
    ],
)
def test_stage1_matches_sage_tpu(dbs, W, Z, Lc, tol):
    jdb, tdb = dbs
    R, B, Pk = 40, 6, 64
    peaks, ints = _segment(jdb, W, R, B, Pk, seed=W + Z)
    kw = dict(max_precursor_charge=4)
    js = jsearch.Scorer(jdb, jsearch.SearchParams(
        precursor_tol=jmass.Tolerance("ppm", -20.0, 20.0),
        fragment_tol=jmass.Tolerance(*tol), **kw))
    ts = tsearch.Scorer(tdb, tsearch.SearchParams(
        precursor_tol=tmass.Tolerance("ppm", -20.0, 20.0),
        fragment_tol=tmass.Tolerance(*tol), **kw), device="cpu")
    assert ts.tables.P_pad == js.tables.P_pad
    if Lc is not None:
        assert Lc < ts.tables.L
    jfn, jco = js._stage1(W, Pk, R, Z, Lc)
    jrun = getattr(jfn, "_unpacked", jfn)
    want = np.asarray(jrun(jnp.asarray(peaks), jnp.asarray(ints[:5])))
    tfn, tco = ts._stage1(W, Pk, R, Z, Lc)
    got = tfn(torch.from_numpy(peaks), torch.from_numpy(ints[:5])).numpy()
    assert jco == tco == (W <= ts.K)
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, want)
    counts = got[:, : min(W, ts.K)]
    assert (counts > 0).any()
    if W > ts.K:
        # ties in the top-K: equal counts must come out peptide-descending
        vals, pep = got[:, : ts.K], got[:, ts.K : 2 * ts.K]
        tie = (vals[:, 1:] == vals[:, :-1])
        assert tie.any()
        assert (pep[:, 1:][tie] < pep[:, :-1][tie]).all()


def test_tensor_on_cpu_takes_plain_version(dbs):
    """A CPU tensor goes to the plain version; the kernel's launch count
    does not move."""
    _, tdb = dbs
    ts = tsearch.Scorer(tdb, tsearch.SearchParams(
        precursor_tol=tmass.Tolerance("ppm", -20.0, 20.0),
        fragment_tol=tmass.Tolerance("ppm", -10.0, 10.0)), device="cpu")
    peaks, ints = _segment(tdb, 32, 8, 2, 32, seed=1)
    before = pallas_stage1.launches
    a = pallas_stage1.stage1_counts(
        ts.tables.lad_index, torch.from_numpy(peaks[0]),
        torch.from_numpy(ints[:5]), W=32, Lc=ts.tables.L, Z=2,
        tol=("ppm", -10.0, 10.0),
    )
    b = pallas_stage1.stage1_counts_plain(
        ts.tables.lad_index, torch.from_numpy(peaks[0]),
        torch.from_numpy(ints[:5]), W=32, Lc=ts.tables.L, Z=2,
        tol=("ppm", -10.0, 10.0),
    )
    assert pallas_stage1.launches == before
    assert torch.equal(a, b)


def _on_bound_segment(tol, Z):
    """A stage-1 segment whose ladder slots lie exactly on the IEEE
    bounds of its peaks (and one ulp either side), at peak masses where
    XLA's folded bound differs from the IEEE one: candidate i holds
    ``on_bound_masses`` of centre i in its first series, the peaks rows
    hold the centres (row 1 every other one) and +inf pads. Rows cover
    each plane count 1..Z and windows that leave candidates out."""
    cs = bound_centres(tol, 6)
    P_pad, S, L, W = 16, 2, 8, 8
    lad = np.full((P_pad, S, L), -np.inf, np.float32)
    for i, c in enumerate(cs):
        lad[i, 0, :6] = on_bound_masses(tol, c)
        lad[i, 1, 0] = np.float32(c) * np.float32(0.5)
    peaks = np.full((2, 8), np.inf, np.float32)
    peaks[0, :6] = np.sort(cs)
    peaks[1, :3] = np.sort(cs[::2])
    rows = []
    for spec in (0, 1):
        for maxz in range(2, Z + 2):
            rows += [(spec, 0, 0, 6, maxz), (spec, 2, 3, 5, maxz),
                     (spec, 0, 1, 1, maxz)]
    ints = np.ascontiguousarray(np.array(rows, np.int32).T)
    return lad, peaks, ints, W, L


def _ieee_counts(lad, peaks, ints, W, Lc, Z, tol):
    """Stage 1's counts in numpy, every bound an IEEE f32 expression."""
    out = np.zeros((ints.shape[1], W), np.int64)
    for r, (spec, p0, i0, i1, maxz) in enumerate(ints.T):
        for w in range(W):
            if not i0 <= p0 + w < i1:
                continue
            f = lad[p0 + w, :, :Lc].ravel()
            for z in range(min(Z, maxz - 1)):
                lo, hi = ieee_bounds(tol, peaks[spec] * np.float32(z + 1))
                out[r, w] += int((f[:, None] >= lo[None]).sum()
                                 - (f[:, None] > hi[None]).sum())
    return out


def _sage_tpu_counts(lad, peaks, ints, W, Lc, Z, tol, algsimp):
    """sage_tpu's count_fragment_matches over the segment's rows, jitted
    with XLA's algebraic simplifier off (``algsimp=False``) or with the
    default passes."""
    import jax

    jtol = jmass.Tolerance(*tol)

    def row(f, pk, maxz):
        return jsearch.count_fragment_matches(f, None, pk, jtol, maxz, Z)

    spec, p0, i0, i1, maxz = ints
    gidx = p0[:, None] + np.arange(W)[None, :]
    f = np.ascontiguousarray(lad[gidx][..., :Lc].transpose(0, 2, 1, 3))
    args = [jnp.asarray(f), jnp.asarray(peaks[spec]), jnp.asarray(maxz)]
    fn = jax.jit(jax.vmap(row))
    if not algsimp:
        fn = fn.lower(*args).compile(
            compiler_options={"xla_disable_hlo_passes": "algsimp"})
    counts = np.asarray(fn(*args))
    return np.where((gidx >= i0[:, None]) & (gidx < i1[:, None]), counts, 0)


@pytest.mark.parametrize("tol", [("ppm", -10.0, 10.0), ("ppm", -20.0, 20.0),
                                 ("pct", -0.001, 0.002)])
@pytest.mark.parametrize("Z", [1, 3])
def test_stage1_on_ieee_bounds(tol, Z):
    """Fragments exactly on their peaks' IEEE bounds and one ulp either
    side, where XLA's folded bound differs: the port's plain stage-1
    counts equal a numpy IEEE count and sage_tpu's counts compiled with
    the algebraic simplifier off, and every candidate in range counts
    its four on-window fragments once a peak of its centre."""
    lad, peaks, ints, W, Lc = _on_bound_segment(tol, Z)
    got = pallas_stage1.stage1_counts_plain(
        torch.from_numpy(lad), torch.from_numpy(peaks),
        torch.from_numpy(ints), W=W, Lc=Lc, Z=Z, tol=tol).numpy()
    want = _ieee_counts(lad, peaks, ints, W, Lc, Z, tol)
    np.testing.assert_array_equal(got[:, :W], want)
    np.testing.assert_array_equal(got[:, W], want.sum(1))
    np.testing.assert_array_equal(got[:, W + 1], (want > 0).sum(1))
    np.testing.assert_array_equal(
        got[:, :W], _sage_tpu_counts(lad, peaks, ints, W, Lc, Z, tol,
                                     algsimp=False))
    assert set(np.unique(want)) == {0, 4}


def test_stage1_smem_has_no_peak_ceiling():
    """The kernel's shared memory (the wrapper's mirror of its sizing)
    grows with Pk only up to one tile of 1024 peaks: at the 12,000 peaks
    a spectrum of ``max_peaks`` 12,000 gives, at Z = 3 and W = 50, it is
    what 1024 peaks take, and within a block's 227 KB; up to one tile it
    is the untiled layout's 32 Z ceil(Pk / 4) + 16,384 + 4 W."""
    smem = pallas_stage1.stage1_counts_smem_bytes
    for W, Z in ((50, 3), (4096, 4), (16384, 3)):
        assert smem(W, 12000, Z) == smem(W, 1024, Z) == smem(W, 10**6, Z)
        assert smem(W, 12000, Z) <= 227 * 1024
        for Pk in (1, 128, 160, 1023, 1024):
            assert smem(W, Pk, Z) == 32 * Z * -(-Pk // 4) + 16384 + 4 * W
