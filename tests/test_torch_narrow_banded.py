"""The port's peak-major banded narrow stage 1 against sage_tpu on the CPU.

The banded count (a bounded binary search over a (band, m/z)-sorted
fragment index, then the open search's count core) must give the packed
[R, 2K+2] per-row top-K and the largest entry count of sage_tpu's
``_banded_count``, and whole FeatureTables equal to sage_tpu's under
``SAGE_TPU_NARROW_BANDED=1`` and to the port's own candidate-major stage
1. Tolerance: exact (equal integers and f32 bits)."""

import jax  # noqa: F401  (conftest keeps JAX on the CPU)
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import sage_tpu.chem.fasta as jfasta
import sage_tpu.chem.mass as jmass
import sage_tpu.index.builder as jbuilder
import sage_tpu.ops.narrow_banded as jbanded
import sage_tpu.ops.search as jsearch
import sage_tpu.spectrum.processor as jproc
import sage_tpu_torch.chem.fasta as tfasta
import sage_tpu_torch.chem.mass as tmass
import sage_tpu_torch.index.builder as tbuilder
import sage_tpu_torch.ops.narrow_banded as tbanded
import sage_tpu_torch.ops.pallas_sort as tsort
import sage_tpu_torch.ops.search as tsearch
import sage_tpu_torch.spectrum.processor as tproc
import _peak_cases as pc
from test_torch_search import _build, _params, _spectra, assert_tables_equal

AA = np.frombuffer(b"ACDEFGHIKLMNPQRSTVWY", dtype=np.uint8)
PREC = ("da", -60.0, 60.0)
FRAG = ("ppm", -10.0, 10.0)


def wide_setup(rng_seed=7, n_spec=8):
    """``_wide_synth_setup`` of tests/test_search_golden.py for both
    packages: its 60-protein FASTA and spectra drawn from b/y ladders
    (the same random stream), as (jax db, port db, spectrum arrays)."""
    rng = np.random.default_rng(rng_seed)
    text = "\n".join(
        f">sp|W{i:03d}|W{i}_SYN synthetic\n"
        + AA[rng.integers(0, len(AA), size=260)].tobytes().decode()
        for i in range(60)
    )
    jdb = _build(jfasta, jbuilder, text)
    tdb = _build(tfasta, tbuilder, text)
    b, y = jdb.table.ladders()
    targets = np.flatnonzero(jdb.table.lens >= 8)
    arrays = []
    for _ in range(n_spec):
        p = int(targets[rng.integers(0, targets.size)])
        n = int(jdb.table.lens[p]) - 1
        frags = np.concatenate([b[p, :n], y[p, :n]])
        take = frags[rng.random(frags.shape[0]) < 0.8]
        masses = np.sort(take.astype(np.float32))
        intens = rng.uniform(1.0, 1e5, masses.shape[0]).astype(np.float32)
        arrays.append({"masses": masses, "intens": intens, "charge": 2,
                       "mz": float(jdb.table.mono[p]) / 2 + jmass.PROTON})
    return jdb, tdb, arrays


@pytest.fixture(scope="module")
def setup():
    return wide_setup()


def _scorers(setup, **kw):
    jdb, tdb, _ = setup
    kw.setdefault("report_psms", 2)
    kw.setdefault("min_matched_peaks", 1)
    return (jsearch.Scorer(jdb, _params(jsearch, jmass, PREC, FRAG, **kw)),
            tsearch.Scorer(tdb, _params(tsearch, tmass, PREC, FRAG, **kw),
                           device="cpu"))


@pytest.fixture
def env(monkeypatch):
    monkeypatch.setenv("SAGE_TPU_OPEN_THRESHOLD", "999999999")
    monkeypatch.setenv("SAGE_TPU_FUSED", "1")
    monkeypatch.setenv("SAGE_TPU_NARROW_BANDED", "1")
    return monkeypatch


def _fused_rows(ts, spectra):
    """The fused path's row table for a batch, as its banded branch
    builds it: [8, R] (spectrum, p0, i0, i1, maxz, z, iso, slot), R the
    row count padded to a power of two with sentinel rows."""
    rows = ts._expand_rows(spectra)
    n = rows["si"].size
    R = tbuilder.next_power_of_two(max(n, 8))
    starts = np.r_[0, np.flatnonzero(np.diff(rows["si"])) + 1]
    cnt = np.diff(np.r_[starts, n])
    slot = np.arange(n) - np.repeat(starts, cnt)
    maxz = np.maximum(rows["z"], 2)
    ints = tsearch._open_ints(R, len(spectra), rows, np.arange(n), maxz, slot)
    Zb = min(int(maxz.max()) - 1, ts.Z)
    return rows, ints, R, Zb


@pytest.mark.parametrize("band_w", ["16", "4096"])
def test_banded_count_matches_sage_tpu(setup, env, band_w):
    """Packed [R, 2K+2] and totmax of both ``_banded_count``s on the same
    peaks and rows, with many bands (16 peptides each, several covered a
    spectrum) and with one band."""
    env.setenv("SAGE_TPU_NARROW_BAND_W", band_w)
    js, ts = _scorers(setup)
    spectra = _spectra(tproc, setup[2])
    masses, intens, Pk = ts._pad_peaks(spectra)
    rows, ints, R, Zb = _fused_rows(ts, spectra)
    frag = tmass.Tolerance(*FRAG)
    jnb = jbanded.NarrowBanded(setup[0], js.K)
    tnb = tbanded.NarrowBanded(setup[1], ts.K, device="cpu")
    assert (jnb.n_bands, jnb.nstep) == (tnb.n_bands, tnb.nstep)
    np.testing.assert_array_equal(jnb.band_off, tnb.band_off)
    peaks = np.stack([masses, intens])
    jp, jt, jF = jnb.dispatch(jnp.asarray(peaks), rows, jnp.asarray(ints), R,
                              Zb, jmass.Tolerance(*FRAG), Pk)
    tp, tt, tF, nbcov = tnb.dispatch(torch.from_numpy(peaks), rows,
                                     torch.from_numpy(ints), R, Zb, frag, Pk)
    assert jF == tF and (nbcov > 1) == (band_w == "16")
    assert int(np.asarray(jt)[0]) == int(tt[0]) < tF
    assert int((tp[:, :ts.K] > 0).sum()) > 0
    np.testing.assert_array_equal(np.asarray(jp), tp.numpy())


def test_banded_count_spectrum_chunks(setup, env, monkeypatch):
    """An entry budget of three spectra a count-core call: the batch runs
    in chunks of spectra (the path of a large F on a large batch), with
    the packed output and totmax of the one-call run."""
    env.setenv("SAGE_TPU_NARROW_BAND_W", "16")
    _js, ts = _scorers(setup)
    spectra = _spectra(tproc, setup[2])
    masses, intens, Pk = ts._pad_peaks(spectra)
    rows, ints, R, Zb = _fused_rows(ts, spectra)
    frag = tmass.Tolerance(*FRAG)
    nb = tbanded.NarrowBanded(setup[1], ts.K, device="cpu")
    peaks = torch.from_numpy(np.stack([masses, intens]))
    ints_t = torch.from_numpy(ints)
    whole, tot, F, _ = nb.dispatch(peaks, rows, ints_t, R, Zb, frag, Pk)
    calls = []
    core = tbanded._open_count_core
    monkeypatch.setattr(tbanded, "_open_count_core",
                        lambda *a, **k: calls.append(k["R"]) or core(*a, **k))
    monkeypatch.setattr(tbanded, "_CHUNK_ELEMS", 3 * F)
    parts, tot_c, _, _ = nb.dispatch(peaks, rows, ints_t, R, Zb, frag, Pk)
    assert len(calls) == -(-len(spectra) // 3) and sum(calls) == len(rows["si"])
    assert int(tot_c[0]) == int(tot[0])
    assert int((whole[:, :ts.K] > 0).sum()) > 0
    assert torch.equal(parts, whole)


def _tables(js, ts, spectra_arrays):
    return (js.score_table(_spectra(jproc, spectra_arrays)),
            ts.score_table(_spectra(tproc, spectra_arrays)))


@pytest.mark.parametrize("band_w", ["16", "4096"])
def test_banded_tables_match(setup, env, band_w):
    """Whole FeatureTables: the port's banded path equals sage_tpu's
    banded path and the port's candidate-major stage 1 (the second call
    takes the banded path itself, no overflow redo)."""
    env.setenv("SAGE_TPU_NARROW_BAND_W", band_w)
    js, ts = _scorers(setup)
    arrays = setup[2]
    _tables(js, ts, arrays)  # F adapts
    reruns = ts.fused_reruns
    js._psm_counter = ts._psm_counter = 1
    jt, tt = _tables(js, ts, arrays)
    assert ts.fused_reruns == reruns
    assert ts.last_plan["banded"]
    assert len(tt) > 0
    assert_tables_equal(jt, tt)
    env.setenv("SAGE_TPU_NARROW_BANDED", "0")
    _j, ts0 = _scorers(setup)
    t0 = ts0.score_table(_spectra(tproc, arrays))
    assert "banded" not in ts0.last_plan
    assert_tables_equal(t0, tt)


def test_banded_overflow_takes_two_dispatch(setup, env):
    """F far below the entry counts: F grows, the batch is redone through
    the two-dispatch path, and the columns equal sage_tpu's and the
    candidate-major ones."""
    js, ts = _scorers(setup)
    js._narrow_banded_maybe(256)._F = 128
    nb = ts._narrow_banded_maybe(256)
    nb._F = 128
    calls = []
    two = ts._two_dispatch
    ts._two_dispatch = lambda *a: calls.append(1) or two(*a)
    jt, tt = _tables(js, ts, setup[2])
    assert nb._F > 128 and calls == [1] and ts.fused_reruns == 1
    assert_tables_equal(jt, tt)
    env.setenv("SAGE_TPU_NARROW_BANDED", "0")
    _j, ts0 = _scorers(setup)
    assert_tables_equal(ts0.score_table(_spectra(tproc, setup[2])), tt)


def test_banded_hierarchical_sort(setup, env, monkeypatch):
    """F = 40,000 entries a spectrum: every entry row takes the cluster
    kernel's plain version (rows past 2^15 keys, 3 slices); the columns
    equal the candidate-major ones."""
    slices = []
    plain = tsort.cluster_sort_plain

    def spy(x, block=None):
        slices.append(tsort.cluster_shape(x.shape[1], block)[0])
        return plain(x, block)

    monkeypatch.setattr(tsort, "cluster_sort_plain", spy)
    _j, ts = _scorers(setup)
    ts._narrow_banded_maybe(256)._F = 40000
    tt = ts.score_table(_spectra(tproc, setup[2]))
    assert ts.last_plan["banded"] and ts.last_plan["F"] == 40000
    assert slices and set(slices) == {3}
    env.setenv("SAGE_TPU_NARROW_BANDED", "0")
    _j, ts0 = _scorers(setup)
    assert_tables_equal(ts0.score_table(_spectra(tproc, setup[2])), tt)


GATE_CASES = {
    # (SAGE_TPU_NARROW_BANDED, W, num_fragments, fragment tolerance):
    # banded in the port (where it beat the candidate-major stage 1 on the
    # H100: W >= 16384, ppm fragments up to +-10 ppm), banded in sage_tpu
    # (its TPU gate: W >= 4096 on 2^19 fragments)
    "auto_wide_large": ("", 4096, 1 << 19, FRAG, False, True),
    "auto_wider_ppm": ("", 16384, 1 << 19, FRAG, True, True),
    "auto_wider_wide_ppm": ("", 16384, 1 << 22, ("ppm", -20.0, 20.0),
                            False, True),
    "auto_wider_da": ("", 16384, 1 << 22, ("da", -0.5, 0.5), False, True),
    "auto_narrow": ("", 2048, 1 << 22, FRAG, False, False),
    "auto_small_index": ("", 16384, (1 << 19) - 1, FRAG, False, False),
    "off": ("0", 16384, 1 << 22, FRAG, False, False),
    "forced": ("1", 8, 1000, ("da", -0.5, 0.5), True, True),
}


@pytest.mark.parametrize("case", sorted(GATE_CASES))
def test_banded_auto_gate(setup, monkeypatch, case):
    """The gate with no environment variable, switched off and forced:
    the port's auto case takes the banded stage 1 where it won on the
    H100; sage_tpu's gate decides as documented."""
    env, W, n_frag, frag, want_t, want_j = GATE_CASES[case]
    if env:
        monkeypatch.setenv("SAGE_TPU_NARROW_BANDED", env)
    else:
        monkeypatch.delenv("SAGE_TPU_NARROW_BANDED", raising=False)
    for mod in (jbuilder, tbuilder):
        monkeypatch.setattr(mod.IndexedDatabase, "num_fragments",
                            property(lambda self: n_frag))
    jdb, tdb, _ = setup
    kw = {"report_psms": 2, "min_matched_peaks": 1}
    js = jsearch.Scorer(jdb, _params(jsearch, jmass, PREC, frag, **kw))
    ts = tsearch.Scorer(tdb, _params(tsearch, tmass, PREC, frag, **kw),
                        device="cpu")
    got_t = ts._narrow_banded_maybe(W)
    assert (got_t is not None) == want_t
    assert (js._narrow_banded_maybe(W) is not None) == want_j
    if want_t:
        assert isinstance(got_t, tbanded.NarrowBanded)
        assert got_t.frag_mz_dev.device.type == "cpu"


# ---- the card kernel's algorithm against the plain version -----------------

BANDED_TOLS = {"ppm": ("ppm", -10.0, 10.0), "pct": ("pct", -0.001, 0.002),
               "da": ("da", -0.5, 0.5)}


@pytest.mark.parametrize("nstep", ["full", "short"])
@pytest.mark.parametrize("Zb", [1, 3])
@pytest.mark.parametrize("tol", sorted(BANDED_TOLS))
def test_banded_ranges_model(tol, Zb, nstep):
    """csrc/peak_ranges.cu's banded form (the plain version's bounded
    search run literally, one element a thread, bounds computed in
    place) equals the plain ``_bounded_search`` ranges: starts at NaN,
    -inf and +inf peaks where only the length is masked, empty segments
    (an empty band, invalid slots), fragments exactly on the IEEE bounds
    and one ulp either side, runs of equal masses; ``short`` gives fewer
    steps than the segments need, which both follow step for step."""
    t = BANDED_TOLS[tol]
    frag_mz, off, cs = pc.range_masses(t, seed=Zb + 3)
    nb = off.size - 1
    B, Pk, nbcov = 6, 16, 3
    masses = pc.range_peaks(cs, B, Pk, seed=Zb + 3)
    rng = np.random.default_rng(Zb)
    bands = np.clip(rng.integers(0, nb, B)[:, None] + np.arange(nbcov), 0,
                    nb - 1)
    valid = rng.random((B, nbcov)) < 0.8
    bb = np.zeros((B, nbcov, 2), np.int32)
    bb[:, :, 0] = off[bands]
    bb[:, :, 1] = np.where(valid, off[bands + 1], off[bands])
    n_step = (int(np.ceil(np.log2(np.diff(off).max()))) + 2
              if nstep == "full" else 4)
    kw = dict(Zb=Zb, tol=t, nstep=n_step)
    st, ln = tbanded._banded_ranges(torch.from_numpy(frag_mz),
                                    torch.from_numpy(masses),
                                    torch.from_numpy(bb), **kw)
    w_st, w_ln = pc.model_banded_ranges(frag_mz, masses, bb, **kw)
    np.testing.assert_array_equal(st.numpy(), w_st)
    np.testing.assert_array_equal(ln.numpy(), w_ln)
    assert w_ln.sum() > 0
    # a non-finite peak keeps its searched start, with no length
    bad = ~np.isfinite(np.tile(masses, (1, Zb * nbcov)))
    assert (w_ln[bad] == 0).all() and (w_st[bad] > 0).any()
