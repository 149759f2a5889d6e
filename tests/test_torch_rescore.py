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

from _rescore_cases import (RANDOM, SERIES, TOLS, crafted_cases, ieee_bounds,
                            indexed_case, kernel_cases, random_case,
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

    assert tsearch.rescore_indexed is trescore.rescore_indexed
    assert sharding.rescore_indexed is trescore.rescore_indexed


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


# ---- the kernel's algorithm (csrc/rescore.cu), modelled in numpy -------

def _first(pm, x):
    """The kernel's binary search: the first p where ``pm[p] >= x``
    (``pm.size`` if none), by its loop and its predicate."""
    a, length = 0, pm.size
    while length > 0:
        half = length >> 1
        if pm[a + half] >= x:
            length = half
        else:
            a += half + 1
            length -= half + 1
    return a


def _model(lad, pep, spec, pkm, pki, maxz, live, series, frag_tol, Z):
    """csrc/rescore.cu's algorithm in numpy f32 scalars: compacted slots
    (not -inf, or -inf under da against a row starting at -inf), their
    live (slot, charge) pairs in t order, the binary search for the
    range's start and the walk that ends at the first ``!(pm <= hi)``,
    with the kernel's predicates, and the serial tail over the matched
    pairs only (three chains, one automaton step a pair)."""
    F = np.float32
    kind, tlo, thi = frag_tol
    n, k = pep.shape
    P, S, L = lad.shape
    nterm = [trescore._SERIES_NTERM[s] for s in series]
    outs = [np.zeros((n, k), d) for d in (np.int32, np.int32, F, F, F,
                                          np.int32, np.int32)]
    for r in range(n):
        pm = pkm[min(max(spec[r], 0), pkm.shape[0] - 1)]
        pi = pki[min(max(spec[r], 0), pkm.shape[0] - 1)]
        nl = k if live is None else min(max(int(live[r]), 0), k)
        for j in range(nl):
            lrow = lad[min(max(pep[r, j], 0), P - 1)].ravel()
            zact = max(0, min(Z, int(maxz[r, j]) - 1))
            ninf = kind == "da" and pm[0] == -np.inf
            slots = [x for x in range(S * L)
                     if zact and (lrow[x] != -np.inf or ninf)]
            acc = [F(0.0), F(0.0), F(0.0)]
            cnt = [0, 0]
            runs = [[0, 0, 0, 0], [0, 0, 0, 0]]  # start, length, last, longest
            for x in slots:
                s, l = divmod(x, L)
                for z in range(zact):
                    mz = lrow[x] if z == 0 else F(lrow[x] / F(z + 1))
                    lo, hi = (F(b) for b in ieee_bounds(frag_tol, mz))
                    bi, bm = F(-1.0), F(0.0)
                    for q in range(_first(pm, lo), pm.size):
                        if not pm[q] <= hi:
                            break
                        if pi[q] >= 0 and (pi[q] > bi or (pi[q] == bi
                                                          and pm[q] > bm)):
                            bi, bm = pi[q], pm[q]
                    if not bi >= 0:
                        continue
                    den = F(mz + bm)
                    ppm = F(F(F(bi * F(abs(F(mz - bm)))) * F(2e6))
                            / (F(1.0) if den == 0 else den))
                    t = 0 if nterm[s] else 1
                    acc[t] = F(acc[t] + bi)
                    acc[2] = F(acc[2] + ppm)
                    cnt[t] += 1
                    st = runs[t]
                    if st[2] != l:
                        if st[0] + st[1] == l:
                            st[1] += 1
                        else:
                            st[0], st[1] = l, 1
                        st[3] = max(st[3], st[1])
                        st[2] = l
            for o, v in zip(outs, cnt + acc + [runs[0][3], runs[1][3]]):
                o[r, j] = v
    return outs


def _indexed_torch(c, fn=trescore.rescore_indexed_plain):
    args = [torch.from_numpy(np.asarray(c[k])) for k in
            ("lad", "pep", "spec", "pkm", "pki", "maxz")]
    live = c.get("live")
    outs = fn(*args, None if live is None else torch.from_numpy(live),
              series=c["series"], frag_tol=c["frag_tol"], Z=c["Z"])
    return [o.numpy() for o in outs]


def _as_indexed(case, live=None):
    n, k, S, L = case["f"].shape
    return dict(lad=case["f"].reshape(n * k, S, L),
                pep=np.arange(n * k, dtype=np.int32).reshape(n, k),
                spec=np.arange(n, dtype=np.int32), pkm=case["pkm"],
                pki=case["pki"], maxz=case["maxz"], live=live,
                series=case["series"], frag_tol=case["frag_tol"],
                Z=case["Z"])


# the crafted cases whose rows ascend, as the kernel requires
_MODEL_CASES = sorted(n for n in kernel_cases() if not n.startswith("no_")) + [
    "random_ppm", "random_da_dead", "random_pct_dead"]


def _model_case(name):
    if name == "random_ppm":
        return _as_indexed(shape_case(RANDOM[6]))
    if name == "random_da_dead":
        return indexed_case(5, RANDOM[5])
    if name == "random_pct_dead":
        return indexed_case(9, RANDOM[3])
    return _as_indexed(CRAFTED[name])


@pytest.mark.parametrize("name", _MODEL_CASES)
def test_range_model_matches_plain(name):
    """The kernel's algorithm (binary-searched peak ranges, compacted
    slots, matched pairs only in the serial tail, dead items 0), run in
    numpy, equals the plain version bit for bit: at NaN bounds, equal
    masses, +inf pads, removed (-1) peaks inside the row, peaks on the
    IEEE bounds, lo > hi, -inf slots under da, and dead items."""
    c = _model_case(name)
    want = _indexed_torch(c)
    with np.errstate(all="ignore"):
        got = _model(c["lad"], c["pep"], c["spec"], c["pkm"], c["pki"],
                     c["maxz"], c["live"], c["series"], c["frag_tol"],
                     c["Z"])
    _assert_bits(got, want)
    if c["live"] is not None:
        dead = np.arange(c["pep"].shape[1])[None, :] >= c["live"][:, None]
        assert dead.any() and not any(o[dead].any() for o in want)


@pytest.mark.parametrize("seed,shape", [(1, RANDOM[1]), (2, RANDOM[4]),
                                        (3, RANDOM[7]), (4, RANDOM[9])],
                         ids=["y-da", "by-ppm", "abxy-da", "abxy-da-Z3"])
def test_indexed_plain_matches_sage_tpu(seed, shape):
    """The indexed entry point's plain version (a shuffled ladder table,
    shuffled peak rows, dead items) against sage_tpu's rescore_candidate
    vmapped over the live items, with zeros at the dead ones."""
    c = indexed_case(seed, shape)
    got = _indexed_torch(c)
    n, k = c["pep"].shape
    rows, cols = np.nonzero(np.arange(k)[None, :] < c["live"][:, None])
    dense = dict(f=c["lad"][c["pep"][rows, cols]][:, None],
                 pkm=c["pkm"][c["spec"][rows]], pki=c["pki"][c["spec"][rows]],
                 maxz=c["maxz"][rows, cols][:, None], series=c["series"],
                 frag_tol=c["frag_tol"], Z=c["Z"])
    live_out = _jax(dense)
    want = []
    for o, g in zip(live_out, got):
        w = np.zeros((n, k), g.dtype)
        w[rows, cols] = np.asarray(o).reshape(-1)
        want.append(w)
    _assert_bits(got, want)
    assert (c["live"] < k).any() and got[0].sum() + got[1].sum() > 0


def test_indexed_wrapper_takes_plain_on_cpu():
    c = indexed_case(7, RANDOM[2])
    trescore.launches = 0
    got = _indexed_torch(c, trescore.rescore_indexed)
    assert trescore.launches == 0
    _assert_bits(got, _indexed_torch(c))


def test_rescore_smem_has_no_peak_ceiling():
    """The kernel's shared memory (the wrapper's mirror of its sizing)
    takes no peak count: it is the warps' slot lists, at the search's
    ladders far below a block's 227 KB."""
    import inspect

    assert list(inspect.signature(trescore.rescore_smem_bytes).parameters) \
        == ["S", "L"]
    assert trescore.rescore_smem_bytes(2, 47) == 8 * 192
    assert trescore.rescore_smem_bytes(6, 64) <= 227 * 1024


# ---- the kernel's precondition at every caller -------------------------

_CALLERS = ("fused_narrow", "fused_open", "fused_banded", "two_dispatch",
            "chimera", "grid", "tdf_input")


@pytest.fixture(scope="module")
def port_search():
    from sage_tpu_torch.bench_baseline import synth_fasta, synth_spectra
    from sage_tpu_torch.chem.fasta import Fasta
    from sage_tpu_torch.index.builder import DatabaseParams

    params = DatabaseParams()
    db = params.build(Fasta.parse(synth_fasta(60, seed=3), params.decoy_tag,
                                  True))
    spectra = synth_spectra(db, 48, seed=4)
    for i, s in enumerate(spectra):
        s.precursors[0].charge = 2 + i % 2
    return db, spectra


def _run_caller(caller, db, spectra, monkeypatch, tmp_path):
    """Search ``spectra`` on the CPU through one caller of the rescore;
    returns the Scorer it ran (or None)."""
    import dataclasses

    from sage_tpu_torch.chem.mass import Tolerance
    from sage_tpu_torch.ops.search import Scorer, SearchParams
    from sage_tpu_torch.parallel import sharding

    params = SearchParams(
        precursor_tol=Tolerance("da", -5.0, 5.0),
        fragment_tol=Tolerance("ppm", -10.0, 10.0), min_isotope_err=-1,
        max_isotope_err=1, report_psms=2, min_matched_peaks=2)
    if caller == "fused_open":
        monkeypatch.setenv("SAGE_TPU_OPEN_THRESHOLD", "1")
        params = dataclasses.replace(
            params, precursor_tol=Tolerance("da", -500.0, 100.0))
    if caller == "fused_banded":
        monkeypatch.setenv("SAGE_TPU_NARROW_BANDED", "1")
        monkeypatch.setenv("SAGE_TPU_NARROW_BAND_W", "64")
    if caller == "two_dispatch":
        monkeypatch.setenv("SAGE_TPU_FUSED", "0")
    if caller == "chimera":
        params = dataclasses.replace(params, chimera=True)
    if caller == "grid":
        mesh = sharding.make_mesh(2, 2, devices=["cpu"] * 4)
        sharding.ShardedScorer(db, mesh, params).score_table(spectra)
        return None
    if caller == "tdf_input":
        from sage_tpu_torch.bench_baseline import synth_tdf
        from sage_tpu_torch.io.tdf import TdfReader
        from sage_tpu_torch.spectrum.processor import SpectrumProcessor

        synth_tdf(str(tmp_path / "run.d"), spectra, seed=6)
        proc = SpectrumProcessor(150, False)
        spectra = [proc.process(r)
                   for r in TdfReader().parse(str(tmp_path / "run.d"))]
    scorer = Scorer(db, params, device="cpu")
    cnts = []
    real = scorer._fused_finalize

    def finalize(d, *a, **k):
        S_pad, Ksel = d["S_pad"], d["Ksel"]
        cnts.append(d["fused"][S_pad * Ksel:S_pad * (Ksel + 1), 5].clone())
        return real(d, *a, **k)

    monkeypatch.setattr(scorer, "_fused_finalize", finalize)
    assert len(scorer.score_table(spectra)) > 0
    scorer.live_counts = cnts
    return scorer


@pytest.mark.parametrize("caller", _CALLERS)
def test_callers_meet_the_kernel_precondition(caller, port_search,
                                              monkeypatch, tmp_path):
    """Every caller of the rescore hands it peak rows that ascend in mass
    with no NaN and the +inf pads last, at every row a live item reads,
    and indices in range; the fused paths' ``live`` is each spectrum row's
    live count (``cnt_s``, the stats the finalize reads); chimera's later
    rounds keep the removed peaks' masses (intensity -1) in order."""
    import sage_tpu_torch.ops.search as tsearch
    from sage_tpu_torch.parallel import sharding

    db, spectra = port_search
    calls = []
    real = trescore.rescore_indexed

    def spy(*a, **k):
        calls.append(tuple(a) + ((k.get("live"),) if len(a) == 6 else ()))
        return real(*a, **k)

    monkeypatch.setattr(tsearch, "rescore_indexed", spy)
    monkeypatch.setattr(sharding, "rescore_indexed", spy)
    scorer = _run_caller(caller, db, spectra, monkeypatch, tmp_path)
    assert calls
    removed = False
    for lad, pep, spec, pkm, pki, maxz, live in calls:
        n, k = pep.shape
        nl = (torch.full((n,), k) if live is None
              else live.long().clamp(0, k))
        is_live = torch.arange(k)[None, :] < nl[:, None]
        assert ((pep >= 0) & (pep < lad.shape[0]))[is_live].all()
        rows = spec[nl > 0].long()
        assert ((rows >= 0) & (rows < pkm.shape[0])).all()
        pm, pi = pkm[rows], pki[rows]
        assert not torch.isnan(pm).any()
        assert (pm[:, 1:] >= pm[:, :-1]).all(), caller
        removed |= bool(((pi == -1) & torch.isfinite(pm)).any())
    fused = [c for c in calls if c[-1] is not None]
    assert bool(fused) == caller.startswith(("fused", "tdf"))
    if fused:
        assert len(scorer.live_counts) == len(fused)
        for c, cnt in zip(fused, scorer.live_counts):
            assert torch.equal(c[-1].long(), cnt.long())
            assert (c[-1] < c[1].shape[1]).any()
    if caller == "chimera":
        assert removed


# ---- peak lists past the kernels' old shared-memory ceilings ----------

def _large_peak_spectra(proc_mod, arrays, max_peaks):
    """Raw spectra of ``large_peak_arrays`` through the package's
    SpectrumProcessor keeping ``max_peaks`` peaks (no deisotoping)."""
    proc = proc_mod.SpectrumProcessor(max_peaks, False)
    return [proc.process(proc_mod.RawSpectrum(
        file_id=0, ms_level=2, id=f"scan={i}", centroid=True,
        precursors=[proc_mod.Precursor(mz=a["prec_mz"], charge=a["charge"])],
        scan_start_time=0.1 * i, ion_injection_time=1.0,
        total_ion_current=float(a["intensity"].sum()), mz=a["mz"].copy(),
        intensity=a["intensity"].copy())) for i, a in enumerate(arrays)]


@pytest.mark.parametrize("fused", ["1", "0"])
def test_large_peak_lists_match_sage_tpu(fused, monkeypatch):
    """Spectra of 1,500 peaks searched with max_peaks 1,200 (past the
    stage-1 kernel's one tile of 1,024 peaks) and fragment charges up to
    3, on the fused and the two-dispatch path: every FeatureTable column
    equals sage_tpu's. The card's twin runs 12,000 peaks."""
    import sage_tpu.chem.fasta as jfasta
    import sage_tpu.index.builder as jbuilder
    import sage_tpu.spectrum.processor as jproc
    import sage_tpu_torch.chem.fasta as tfasta
    import sage_tpu_torch.chem.mass as tmass
    import sage_tpu_torch.index.builder as tbuilder
    import sage_tpu_torch.ops.search as tsearch
    import sage_tpu_torch.spectrum.processor as tproc
    from sage_tpu_torch.bench_baseline import synth_fasta
    from test_torch_search import assert_tables_equal

    from _rescore_cases import large_peak_arrays

    monkeypatch.setenv("SAGE_TPU_FUSED", fused)
    text = synth_fasta(30, seed=8)
    dbs = [b.DatabaseParams().build(f.Fasta.parse(
        text, b.DatabaseParams().decoy_tag, True))
        for f, b in ((jfasta, jbuilder), (tfasta, tbuilder))]
    arrays = large_peak_arrays(dbs[1], 6, 1500, seed=12)
    tables = []
    for db, search, mass, proc in ((dbs[0], jsearch, jmass, jproc),
                                   (dbs[1], tsearch, tmass, tproc)):
        params = search.SearchParams(
            precursor_tol=mass.Tolerance("ppm", -20.0, 20.0),
            fragment_tol=mass.Tolerance("ppm", -10.0, 10.0),
            max_fragment_charge=3, report_psms=2, min_matched_peaks=2)
        kw = {} if search is jsearch else {"device": "cpu"}
        spectra = _large_peak_spectra(proc, arrays, 1200)
        assert {len(s.masses) for s in spectra} == {1200}
        tables.append(search.Scorer(db, params, **kw).score_table(spectra))
    assert len(tables[1]) > 0
    assert_tables_equal(tables[0], tables[1])
    assert (tables[1].columns["matched_peaks"] > 10).any()
