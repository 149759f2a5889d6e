"""The PyTorch port's two-dispatch search against sage_tpu on the CPU.

Where the fused path declines a batch (``SAGE_TPU_FUSED=0``, its packing
preconditions, an open batch split deeper than one level, per-spectrum
sums past 2^24), both packages take the two-dispatch path: stage 1, the
host PreScore merge, a per-item full rescore and the host selection. The
same FASTA text and spectra (numpy arrays from a seed) go through
``sage_tpu`` (JAX on the CPU) and ``sage_tpu_torch`` (the plain PyTorch
versions on the CPU); every FeatureTable column must be equal, element
for element."""

import jax  # noqa: F401  (conftest keeps JAX on the CPU)
import numpy as np
import pytest

import sage_tpu.chem.fasta as jfasta
import sage_tpu.chem.mass as jmass
import sage_tpu.index.builder as jbuilder
import sage_tpu.ops.open_search as jopen
import sage_tpu.ops.search as jsearch
import sage_tpu.spectrum.processor as jproc
import sage_tpu_torch.chem.fasta as tfasta
import sage_tpu_torch.chem.mass as tmass
import sage_tpu_torch.index.builder as tbuilder
import sage_tpu_torch.ops.open_search as topen
import sage_tpu_torch.ops.pallas_sort as tsort
import sage_tpu_torch.ops.search as tsearch
import sage_tpu_torch.spectrum.processor as tproc
from test_torch_open_search import OPEN, _arrays, _fasta as _open_fasta
from test_torch_search import (
    _build,
    _fasta,
    _params,
    _spectra,
    _spectra_arrays,
    assert_tables_equal,
)


@pytest.fixture(scope="module")
def narrow_dbs():
    text = _fasta(150, 300, seed=5)
    return _build(jfasta, jbuilder, text), _build(tfasta, tbuilder, text)


@pytest.fixture(scope="module")
def wide_dbs():
    text = _fasta(60, 260, seed=13)
    return _build(jfasta, jbuilder, text), _build(tfasta, tbuilder, text)


@pytest.fixture(scope="module")
def open_dbs():
    text = _open_fasta(40)
    return _build(jfasta, jbuilder, text), _build(tfasta, tbuilder, text)


def _saturated_arrays(db, n, seed):
    """Dense spectra: 400 evenly spaced peaks over the fragment range,
    so that with +-20 Da fragment windows and two fragment charges a
    candidate matches more than 511 (peak, charge, fragment) pairs — past
    the 9-bit count of the JAX package's packed stage-1 layout."""
    rng = np.random.default_rng(seed)
    targets = np.flatnonzero(db.table.lens >= 12)
    out = []
    for _ in range(n):
        p = int(targets[rng.integers(0, targets.size)])
        masses = np.linspace(150.0, 1500.0, 400).astype(np.float32)
        intens = rng.uniform(1.0, 1e5, masses.size).astype(np.float32)
        out.append({"masses": masses, "intens": intens, "charge": 3,
                    "mz": float(db.table.mono[p]) / 3 + float(jmass.PROTON)})
    return out


# Each case: database, spectra (count, charge cycle, seed), precursor and
# fragment tolerances, extra SearchParams.
CASES = {
    # several rows per spectrum (isotope sweep), Wb > K and Wb <= K rows
    "narrow": dict(
        db="narrow", n=64, charges=(2, 3), seed=1,
        prec=("da", -8.0, 8.0), frag=("ppm", -10.0, 10.0),
        kw=dict(min_isotope_err=-1, max_isotope_err=1, min_matched_peaks=1,
                report_psms=2),
    ),
    # _wide_synth_setup's pattern: every window wider than K
    "wide": dict(
        db="wide", n=6, charges=(2,), seed=13,
        prec=("da", -60.0, 60.0), frag=("ppm", -10.0, 10.0),
        kw=dict(report_psms=3, min_matched_peaks=1),
    ),
    # unannotated precursors: one row per charge 2..4
    "charge_sweep": dict(
        db="narrow", n=24, charges=(None,), seed=3,
        prec=("ppm", -2000.0, 2000.0), frag=("da", -0.02, 0.02),
        kw=dict(min_matched_peaks=2, report_psms=2, annotate_matches=True),
    ),
    # 300 spectra with Da windows: width-bucketed stage-1 segments
    "bucketed": dict(
        db="wide", n=300, charges=(2,), seed=29,
        prec=("da", -40.0, 40.0), frag=("ppm", -10.0, 10.0),
        kw=dict(report_psms=2, min_matched_peaks=1),
    ),
    # a preliminary count above 511
    "saturated": dict(
        db="wide", n=4, charges=(3,), seed=47, saturated=True,
        prec=("da", -60.0, 60.0), frag=("da", -20.0, 20.0),
        kw=dict(report_psms=3, min_matched_peaks=1),
    ),
}


def _spy(monkeypatch, obj, name):
    """Record each call of ``obj.name``'s arguments and result."""
    calls = []
    real = getattr(obj, name)

    def spy(*a, **k):
        out = real(*a, **k)
        calls.append((a, k, out))
        return out

    monkeypatch.setattr(obj, name, spy)
    return calls


@pytest.mark.parametrize("case", sorted(CASES))
def test_two_dispatch_matches_sage_tpu(case, narrow_dbs, wide_dbs,
                                       monkeypatch):
    """Under SAGE_TPU_FUSED=0 every column equals sage_tpu's two-dispatch
    table, and equals the port's own fused table."""
    c = CASES[case]
    jdb, tdb = narrow_dbs if c["db"] == "narrow" else wide_dbs
    monkeypatch.setenv("SAGE_TPU_OPEN_THRESHOLD", "999999999")
    make = _saturated_arrays if c.get("saturated") else (
        lambda db, n, seed: _spectra_arrays(db, n, c["charges"], seed))
    arrays = make(jdb, c["n"], c["seed"])

    def scorers():
        return (
            jsearch.Scorer(jdb, _params(jsearch, jmass, c["prec"], c["frag"],
                                        **c["kw"])),
            tsearch.Scorer(tdb, _params(tsearch, tmass, c["prec"], c["frag"],
                                        **c["kw"]), device="cpu"),
        )

    monkeypatch.setenv("SAGE_TPU_FUSED", "0")
    js, ts = scorers()
    parts = _spy(monkeypatch, ts, "_prelim_part")
    t_jax = js.score_table(_spectra(jproc, arrays))
    t_port = ts.score_table(_spectra(tproc, arrays))
    assert len(t_port) > 0
    assert_tables_equal(t_jax, t_port)
    assert parts, "the port did not take the two-dispatch path"

    if case == "bucketed":
        assert len(parts) >= 2, "no width-bucketed stage-1 segments"
    if case == "saturated":
        # the JAX package's packed layout saturates and redoes unpacked;
        # the port's exact layout holds the same count
        d = js._prelim_dispatch(_spectra(jproc, arrays))
        assert d["packed"]
        raw_max = np.asarray(d["out_dev"])[: d["n_rows"], js.K]
        assert raw_max.max() > 511
        (d_p, _K), _k, _out = parts[0]
        counts = d_p["out_dev"].numpy()[: d_p["n_rows"], : ts.K]
        assert counts.max() == raw_max.max()
    if c["kw"].get("annotate_matches"):
        assert any(f.charges for f in t_port.fragments)

    monkeypatch.setenv("SAGE_TPU_FUSED", "1")
    _js, ts_fused = scorers()
    assert_tables_equal(t_port, ts_fused.score_table(_spectra(tproc, arrays)))


@pytest.mark.parametrize("cores", [1, 8])
def test_two_dispatch_stream_matches_score_table(wide_dbs, monkeypatch,
                                                 cores):
    """Under SAGE_TPU_FUSED=0, score_stream over 3 batches equals
    score_table batch by batch and sage_tpu's score_stream (psm ids
    included), on both of pipeline_stream's loops."""
    import os

    jdb, tdb = wide_dbs
    monkeypatch.setenv("SAGE_TPU_OPEN_THRESHOLD", "999999999")
    monkeypatch.setenv("SAGE_TPU_FUSED", "0")
    monkeypatch.setattr(os, "cpu_count", lambda: cores)
    arrays = _spectra_arrays(jdb, 9, (2, 3), seed=8)
    prec, frag = ("da", -60.0, 60.0), ("ppm", -10.0, 10.0)
    kw = dict(report_psms=2, min_matched_peaks=1)
    cuts = [(0, 4), (4, 6), (6, 9)]
    tsp = _spectra(tproc, arrays)
    jsp = _spectra(jproc, arrays)

    def port():
        return tsearch.Scorer(tdb, _params(tsearch, tmass, prec, frag, **kw),
                              device="cpu")

    ts = port()
    calls = _spy(monkeypatch, ts, "_stage2_dispatch")
    streamed = list(ts.score_stream([tsp[a:b] for a, b in cuts]))
    assert len(calls) == len(cuts)
    ts2 = port()
    js = jsearch.Scorer(jdb, _params(jsearch, jmass, prec, frag, **kw))
    j_streamed = list(js.score_stream([jsp[a:b] for a, b in cuts]))
    for (a, b), st, jt in zip(cuts, streamed, j_streamed):
        assert len(st) > 0
        assert_tables_equal(st, ts2.score_table(tsp[a:b]), skip=("psm_id",))
        assert_tables_equal(jt, st)


def test_merge_prescore_candidates_matches_sage_tpu():
    """The host PreScore merge: the same selection, in the same order,
    for random candidates with ties on every key."""
    rng = np.random.default_rng(3)
    n = 4000
    m = rng.integers(0, 5, n).astype(np.int32)
    pp = rng.integers(0, 60, n).astype(np.int32)
    ss = np.sort(rng.integers(0, 40, n)).astype(np.int32)
    zz = rng.integers(2, 5, n).astype(np.int32)
    ii = rng.integers(-1, 2, n).astype(np.int32)
    for K in (1, 7, 50):
        np.testing.assert_array_equal(
            tsearch.merge_prescore_candidates(m, pp, ss, zz, ii, K),
            jsearch.merge_prescore_candidates(m, pp, ss, zz, ii, K),
        )


def test_open_prelim_counts_match_sage_tpu(open_dbs, monkeypatch):
    """The open search's preliminary candidates (counts, peptides,
    charges, isotopes, Poisson statistics) equal sage_tpu's, on the setup
    of tests/test_open_search.py's index-walk check."""
    jdb, tdb = open_dbs
    monkeypatch.setenv("SAGE_TPU_OPEN_THRESHOLD", "1")
    prec, frag = ("da", -120.0, 120.0), ("ppm", -15.0, 15.0)
    arrays = _arrays(jdb, 6, 11)
    js = jsearch.Scorer(jdb, _params(jsearch, jmass, prec, frag))
    ts = tsearch.Scorer(tdb, _params(tsearch, tmass, prec, frag),
                        device="cpu")
    jsp, tsp = _spectra(jproc, arrays), _spectra(tproc, arrays)
    want = js._preliminary(jsp, masses=js._pad_peaks(jsp)[0])
    got = ts._preliminary(tsp, masses=ts._pad_peaks(tsp)[0])
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert (got["cand_matched"] > 1).any()


def _depth_spy(monkeypatch, os_):
    """Record the recursion depth of each preliminary_packed call."""
    depth = [0]
    seen = []
    real = os_.preliminary_packed

    def spy(*a, **k):
        seen.append(depth[0])
        depth[0] += 1
        try:
            return real(*a, **k)
        finally:
            depth[0] -= 1

    monkeypatch.setattr(os_, "preliminary_packed", spy)
    return seen


@pytest.mark.parametrize("fused", ["0", "1"])
def test_open_split_two_levels_matches_sage_tpu(open_dbs, monkeypatch, fused):
    """A batch over the element budget is split recursively, two levels
    deep, through the two-dispatch path (with SAGE_TPU_FUSED=1 the fused
    path declines it): every column equals sage_tpu's and the unsplit
    table."""
    jdb, tdb = open_dbs
    monkeypatch.setenv("SAGE_TPU_OPEN_THRESHOLD", "1")
    monkeypatch.setenv("SAGE_TPU_FUSED", fused)
    prec, frag = ("da", -300.0, 100.0), ("ppm", -15.0, 15.0)
    kw = dict(min_isotope_err=-1, max_isotope_err=1)
    arrays = _arrays(jdb, 24, 21, charge=2)
    ts0 = tsearch.Scorer(tdb, _params(tsearch, tmass, prec, frag, **kw),
                         device="cpu")
    t_whole = ts0.score_table(_spectra(tproc, arrays))
    # a third of the whole batch's footprint: each half is still over it,
    # each quarter under it
    masses = ts0._pad_peaks(_spectra(tproc, arrays))[0]
    rows = ts0._expand_rows(_spectra(tproc, arrays))
    *_, size, _, _, nbcov = ts0._open_searcher()._geometry(masses, rows, 1,
                                                           None)
    budget = len(arrays) * nbcov * (int(size.max()) + 1) // 3
    monkeypatch.setattr(jopen.OpenSearcher, "MAX_ELEMENTS", budget)
    monkeypatch.setattr(topen.OpenSearcher, "MAX_ELEMENTS", budget)
    js = jsearch.Scorer(jdb, _params(jsearch, jmass, prec, frag, **kw))
    ts = tsearch.Scorer(tdb, _params(tsearch, tmass, prec, frag, **kw),
                        device="cpu")
    depths = _depth_spy(monkeypatch, ts._open_searcher())
    t_j = js.score_table(_spectra(jproc, arrays))
    t_p = ts.score_table(_spectra(tproc, arrays))
    assert max(depths) >= 2, depths
    assert len(t_p) > 0
    assert_tables_equal(t_j, t_p, skip=("psm_id",))
    assert_tables_equal(t_whole, t_p, skip=("psm_id",))


@pytest.mark.parametrize("regime", ["open", "isotope_range", "overflow"])
def test_formerly_raising_regimes_match_sage_tpu(regime, wide_dbs,
                                                 monkeypatch):
    """Regimes that raised NotImplementedError before the two-dispatch
    path was ported now fall back to it as sage_tpu does, with equal
    columns: an open batch over the element budget after one split level,
    an isotope-error range past the fused path's 5-bit lane, and
    per-spectrum matched sums reported at 2^24."""
    jdb, tdb = wide_dbs
    kw = dict(min_matched_peaks=1)
    prec = ("da", -50.0, 50.0)
    if regime == "isotope_range":
        kw["max_isotope_err"] = 16
    if regime == "open":
        monkeypatch.setenv("SAGE_TPU_OPEN_THRESHOLD", "8")
        monkeypatch.setattr(jopen.OpenSearcher, "MAX_ELEMENTS", 1)
        monkeypatch.setattr(topen.OpenSearcher, "MAX_ELEMENTS", 1)
        charges = (2, 3)
    else:
        monkeypatch.setenv("SAGE_TPU_OPEN_THRESHOLD", "999999999")
        charges = (2,)
    arrays = _spectra_arrays(jdb, 2 if regime == "open" else 4, charges,
                             seed=3)
    frag = ("ppm", -10.0, 10.0)
    ts = tsearch.Scorer(tdb, _params(tsearch, tmass, prec, frag, **kw),
                        device="cpu")
    prelim = _spy(monkeypatch, ts, "_prelim_dispatch")
    if regime == "overflow":
        real = tsearch.Scorer._fused_dispatch

        def dispatch(self, *a, **k):
            d = real(self, *a, **k)
            d["fused"] = d["fused"].clone()
            d["fused"][d["S_pad"] * d["Ksel"], 2] = float(1 << 24)
            return d

        monkeypatch.setattr(tsearch.Scorer, "_fused_dispatch", dispatch)
        # the JAX package's table on the path it falls back to
        monkeypatch.setenv("SAGE_TPU_FUSED", "0")
    js = jsearch.Scorer(jdb, _params(jsearch, jmass, prec, frag, **kw))
    t_j = js.score_table(_spectra(jproc, arrays))
    monkeypatch.delenv("SAGE_TPU_FUSED", raising=False)
    t_p = ts.score_table(_spectra(tproc, arrays))
    assert prelim, "the port did not fall back to the two-dispatch path"
    assert len(t_p) > 0
    assert_tables_equal(t_j, t_p)


def test_open_sort_gate_matches_sage_tpu(open_dbs, monkeypatch):
    """Entry rows past MAX_F keys (lowered here to 256; one band, +-0.5
    Da fragments) are sorted by torch.sort, as sage_tpu's lax.sort sorts
    them: every column equals sage_tpu's."""
    jdb, tdb = open_dbs
    monkeypatch.setenv("SAGE_TPU_OPEN_THRESHOLD", "1")
    monkeypatch.setenv("SAGE_TPU_OPEN_BANDS", "1")
    monkeypatch.setattr(tsort, "MAX_F", 256)
    gates = []
    real = topen.use_pallas_sort
    monkeypatch.setattr(
        topen, "use_pallas_sort",
        lambda F, n_pep: gates.append((F, real(F, n_pep))) or gates[-1][1])
    frag = ("da", -0.5, 0.5)
    arrays = _arrays(jdb, 12, 5)
    js = jsearch.Scorer(jdb, _params(jsearch, jmass, OPEN, frag,
                                     report_psms=2))
    ts = tsearch.Scorer(tdb, _params(tsearch, tmass, OPEN, frag,
                                     report_psms=2), device="cpu")
    t_j = js.score_table(_spectra(jproc, arrays))
    t_p = ts.score_table(_spectra(tproc, arrays))
    assert any(F > 256 and not ok for F, ok in gates), gates
    assert all(ok == (F <= 256) for F, ok in gates)
    assert len(t_p) > 0
    assert_tables_equal(t_j, t_p, skip=("psm_id",))
