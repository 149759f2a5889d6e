"""The port's multi-device search (``sage_tpu_torch/parallel/sharding.py``)
against the single-device port and against sage_tpu, on the CPU.

Grids are ``cpu`` listed as often as the shape needs: one controller
runs every shard, so any shape runs here. Every comparison is exact.
sage_tpu's own ShardedSearch / ShardedScorer run on the 8 virtual CPU
devices of conftest.py. Its whole-table step materialises every
(row, peptide, ion, peak) compare, so the comparisons that run it use a
smaller database (``full_dbs``)."""

import jax  # noqa: F401  (conftest keeps JAX on the CPU)
import numpy as np
import pytest

import sage_tpu.chem.fasta as jfasta
import sage_tpu.chem.mass as jmass
import sage_tpu.index.builder as jbuilder
import sage_tpu.ops.open_search as jopen
import sage_tpu.ops.search as jsearch
import sage_tpu.parallel.sharding as jshard
import sage_tpu.spectrum.processor as jproc
import sage_tpu_torch.chem.fasta as tfasta
import sage_tpu_torch.chem.mass as tmass
import sage_tpu_torch.index.builder as tbuilder
import sage_tpu_torch.ops.open_search as topen
import sage_tpu_torch.ops.search as tsearch
import sage_tpu_torch.parallel.sharding as tshard
import sage_tpu_torch.spectrum.processor as tproc
from sage_tpu_torch.bench_baseline import synth_fasta
from test_torch_search import (
    _build,
    _params,
    _spectra,
    _spectra_arrays,
    assert_tables_equal,
)

SHAPES = [(1, 2), (2, 1), (2, 2), (1, 4)]
NARROW = ("ppm", -20.0, 20.0)
FRAG = ("ppm", -10.0, 10.0)
KW = dict(min_isotope_err=-1, max_isotope_err=1, report_psms=2,
          min_matched_peaks=2)
# the step each path's environment routes to
PATHS = {
    "windowed": ({"SAGE_TPU_SHARD_WINDOWED": "1"}, "win"),
    "full": ({"SAGE_TPU_SHARD_WINDOWED": "0", "SAGE_TPU_SHARD_OPEN": "0"},
             "full"),
    "banded": ({"SAGE_TPU_SHARD_WINDOWED": "0", "SAGE_TPU_SHARD_OPEN": "1"},
               "open"),
}


def _dbs(n_proteins):
    text = synth_fasta(n_proteins)
    return _build(jfasta, jbuilder, text), _build(tfasta, tbuilder, text)


@pytest.fixture(scope="module")
def dbs():
    return _dbs(200)


@pytest.fixture(scope="module")
def full_dbs():
    return _dbs(40)


def _mesh(shape):
    return tshard.make_mesh(*shape, devices=["cpu"] * (shape[0] * shape[1]))


def _set_path(monkeypatch, path):
    for k, v in PATHS[path][0].items():
        monkeypatch.setenv(k, v)


def _both(dbs, arrays, prec=NARROW, frag=FRAG, **kw):
    """The two packages' (params, spectra)."""
    kw = {**KW, **kw}
    return ((_params(jsearch, jmass, prec, frag, **kw),
             _spectra(jproc, arrays)),
            (_params(tsearch, tmass, prec, frag, **kw),
             _spectra(tproc, arrays)))


# ----------------------------------------------------------------------
# ShardedSearch: the stage-1 step and the full step
# ----------------------------------------------------------------------


def _queries(db, R=12, seed=0):
    """sage_tpu's tests/test_sharding.py queries: a peptide's b/y ions as
    peaks, its mass +-0.01 Da as the window, maxz 2; intensities from a
    seed."""
    rng = np.random.default_rng(seed)
    b, y = db.table.ladders()
    mono = db.table.mono
    Pk = 64
    peaks = np.full((R, Pk), np.inf, np.float32)
    lo = np.zeros(R, np.float32)
    hi = np.zeros(R, np.float32)
    for r in range(R):
        i = int(rng.integers(0, len(db)))
        n = max(int(db.table.lens[i]) - 1, 1)
        frs = np.concatenate([b[i, :n], y[i, :n]])
        take = rng.choice(frs, size=min(20, len(frs)), replace=False)
        peaks[r, :len(take)] = np.sort(take)
        lo[r] = mono[i] - 0.01
        hi[r] = mono[i] + 0.01
    lo[-1], hi[-1] = np.inf, -np.inf  # an empty window
    maxz = np.full(R, 2, np.int32)
    intens = np.where(np.isfinite(peaks),
                      rng.uniform(1.0, 1e4, peaks.shape),
                      -1.0).astype(np.float32)
    return peaks, intens, lo, hi, maxz


def _port_steps(db, shape, q):
    ss = tshard.ShardedSearch(db, _mesh(shape),
                              tmass.Tolerance(*FRAG), Z=1, K=50)
    peaks, intens, lo, hi, maxz = q
    return ss(peaks, lo, hi, maxz), ss.full_step(peaks, intens, lo, hi,
                                                 maxz)


@pytest.fixture(scope="module")
def single_steps(dbs):
    q = _queries(dbs[1])
    return q, _port_steps(dbs[1], (1, 1), q)


@pytest.mark.parametrize("shape", SHAPES)
def test_steps_mesh_invariant(dbs, single_steps, shape):
    """The stage-1 step and the full step (stage 2 owner-computes) at
    every shape equal the (1, 1) grid's, every array bit for bit."""
    q, (ref1, ref2) = single_steps
    got1, got2 = _port_steps(dbs[1], shape, q)
    for r, g in zip(ref1 + ref2, got1 + got2):
        np.testing.assert_array_equal(g, r)
    counts = ref2[0]
    assert (counts[:-1, 0] > 0).all() and (counts[-1] == 0).all()
    assert (ref2[2][counts > 0] > 0).any()  # stage 2 matched b ions


def _assert_step_equal(port, jx):
    """Port step arrays against sage_tpu's: counts, totals and features
    equal; the peptide of every live slot equal, and -1 (no peptide) in
    every zero-count slot, which sage_tpu fills with a zero-count
    peptide."""
    counts = jx[0]
    np.testing.assert_array_equal(port[0], counts)
    np.testing.assert_array_equal(port[1],
                                  np.where(counts > 0, jx[1], -1))
    for p, j in zip(port[2:], jx[2:]):
        np.testing.assert_array_equal(p, np.asarray(j))


def test_steps_match_sage_tpu(full_dbs):
    """Both steps at (2, 2) against sage_tpu's ShardedSearch at (2, 2)."""
    jdb, tdb = full_dbs
    q = _queries(tdb)
    peaks, intens, lo, hi, maxz = q
    ss = jshard.ShardedSearch(jdb, jshard.make_mesh(2, 2),
                              jmass.Tolerance(*FRAG), Z=1, K=50)
    j1 = tuple(np.asarray(x) for x in ss(peaks, lo, hi, maxz))
    j2 = tuple(np.asarray(x)
               for x in ss.full_step(peaks, intens, lo, hi, maxz))
    p1, p2 = _port_steps(tdb, (2, 2), q)
    _assert_step_equal(p1, j1)
    _assert_step_equal(p2, j2)


# ----------------------------------------------------------------------
# ShardedScorer.score_table on every path
# ----------------------------------------------------------------------


@pytest.fixture(scope="module")
def narrow_case(dbs):
    """24 spectra (charges 2, 3 and unannotated), both packages'
    single-device tables."""
    arrays = _spectra_arrays(dbs[1], 24, [2, 3, None], seed=1)
    (jp, js), (tp, ts) = _both(dbs, arrays)
    jt = jsearch.Scorer(dbs[0], jp).score_table(js)
    tt = tsearch.Scorer(dbs[1], tp, device="cpu").score_table(ts)
    assert_tables_equal(tt, jt)
    return arrays, tp, tt, jt


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("path", sorted(PATHS))
def test_score_table_paths(dbs, narrow_case, monkeypatch, path, shape):
    """Every FeatureTable column equal to the single-device port's and to
    sage_tpu's single-device Scorer, on each path at each shape."""
    arrays, tp, tt, jt = narrow_case
    _set_path(monkeypatch, path)
    sc = tshard.ShardedScorer(dbs[1], _mesh(shape), tp)
    got = sc.score_table(_spectra(tproc, arrays))
    assert sc.last_route[0] == PATHS[path][1]
    assert len(got) > 20
    assert_tables_equal(got, tt)
    assert_tables_equal(got, jt)


@pytest.mark.parametrize("path", sorted(PATHS))
def test_score_table_matches_sage_tpu_mesh(dbs, full_dbs, narrow_case,
                                           monkeypatch, path):
    """Each path at (2, 2) against sage_tpu's ShardedScorer at (2, 2) (its
    whole-table path on the smaller database)."""
    _set_path(monkeypatch, path)
    if path == "full":
        arrays = _spectra_arrays(full_dbs[1], 8, [2, None], seed=2)
        (jp, js), (tp, ts) = _both(full_dbs, arrays)
        jdb, tdb = full_dbs
    else:
        arrays, tp, _tt, _jt = narrow_case
        (jp, js), (_, ts) = _both(dbs, arrays)
        jdb, tdb = dbs
    jt = jshard.ShardedScorer(jdb, jshard.make_mesh(2, 2), jp).score_table(js)
    got = tshard.ShardedScorer(tdb, _mesh((2, 2)), tp).score_table(ts)
    assert len(got) > 0
    assert_tables_equal(got, jt, skip=("psm_id",))


def test_open_regime_routes_banded(dbs):
    """The open search's -500/+100 Da windows are wider than a shard's
    peptide range at (1, 8): the banded open step by default, equal to
    both packages' single-device Scorers."""
    arrays = _spectra_arrays(dbs[1], 8, [2], seed=11, noise=0)
    (jp, js), (tp, ts) = _both(dbs, arrays, prec=("da", -500.0, 100.0),
                               frag=("ppm", -15.0, 15.0), min_isotope_err=0,
                               max_isotope_err=0)
    sc = tshard.ShardedScorer(dbs[1], _mesh((1, 8)), tp)
    got = sc.score_table(ts)
    assert sc.last_route[0] == "open"
    tt = tsearch.Scorer(dbs[1], tp, device="cpu").score_table(
        _spectra(tproc, arrays))
    jt = jsearch.Scorer(dbs[0], jp).score_table(js)
    assert len(got) > 0
    assert_tables_equal(got, tt)
    assert_tables_equal(got, jt)


@pytest.mark.parametrize("shape", [(1, 2), (2, 4)])
def test_open_ranges_card_form_matches_host(dbs, shape):
    """The grid's range planning on a card (each model shard's segment
    searched as one band by the range search's wrapper, whose plain
    version runs on these CPU devices) equals the host planning, which
    sage_tpu's ShardedScorer does: starts and lengths of every shard,
    spectrum, charge plane and peak."""
    arrays = _spectra_arrays(dbs[1], 12, [2, 3], seed=13, noise=4)
    (_jp, _js), (tp, ts) = _both(dbs, arrays, prec=("da", -500.0, 100.0),
                                 frag=("ppm", -15.0, 15.0))
    sc = tshard.ShardedScorer(dbs[1], _mesh(shape), tp)
    masses = tsearch.Scorer(dbs[1], tp, device="cpu")._pad_peaks(ts)[0]
    search = sc.search
    host = search.open_ranges(masses)
    card = search._open_ranges_card(masses, search._open_tables()[1])
    assert search.Z > 1 and host[1].sum() > 0
    for h, c in zip(host, card):
        np.testing.assert_array_equal(c, h)


def test_stage2_budget_overflow(dbs, monkeypatch):
    """A batch whose live candidates overflow sage_tpu's stage-2 item
    budget (``_initial_bc`` forced to 2, so its step redoes at a larger
    budget): the port rescores every live item in one pass and its
    columns equal sage_tpu's mesh and both single-device Scorers."""
    arrays = _spectra_arrays(dbs[1], 6, [2], seed=5, noise=0)
    (jp, js), (tp, ts) = _both(dbs, arrays, prec=("da", -20.0, 20.0),
                               report_psms=3, min_matched_peaks=1,
                               min_isotope_err=0, max_isotope_err=0)
    jsc = jshard.ShardedScorer(dbs[0], jshard.make_mesh(2, 1), jp)
    monkeypatch.setattr(type(jsc.search), "_initial_bc", lambda self, R: 2)
    jt = jsc.score_table(js)
    grown = [v for k, v in jsc.search._fn_cache.items()
             if isinstance(k, tuple) and k[0].startswith("bc_")]
    assert grown and grown[0] > 2
    sc = tshard.ShardedScorer(dbs[1], _mesh((2, 1)), tp)
    got = sc.score_table(ts)
    assert sc.search.last_live > 2
    tt = tsearch.Scorer(dbs[1], tp, device="cpu").score_table(
        _spectra(tproc, arrays))
    assert len(got) > 0
    assert_tables_equal(got, tt)
    assert_tables_equal(got, jt, skip=("psm_id",))


def test_open_element_budget_fallback(full_dbs, monkeypatch):
    """With MAX_ELEMENTS lowered to 64 in both packages, the banded open
    step declines the batch and the whole-table step scores it: equal
    to sage_tpu's mesh and the single-device port."""
    arrays = _spectra_arrays(full_dbs[1], 4, [2], seed=4, noise=0)
    (jp, js), (tp, ts) = _both(full_dbs, arrays, prec=("da", -300.0, 100.0),
                               frag=("ppm", -15.0, 15.0), report_psms=1,
                               min_isotope_err=0, max_isotope_err=0)
    monkeypatch.setenv("SAGE_TPU_SHARD_WINDOWED", "0")
    tt = tsearch.Scorer(full_dbs[1], tp, device="cpu").score_table(
        _spectra(tproc, arrays))
    monkeypatch.setattr(jopen.OpenSearcher, "MAX_ELEMENTS", 64)
    monkeypatch.setattr(topen.OpenSearcher, "MAX_ELEMENTS", 64)
    jsc = jshard.ShardedScorer(full_dbs[0], jshard.make_mesh(2, 2), jp)
    jt = jsc.score_table(js)
    assert not any(isinstance(k, tuple) and k[0] == "open"
                   for k in jsc.search._fn_cache)
    sc = tshard.ShardedScorer(full_dbs[1], _mesh((2, 2)), tp)
    got = sc.score_table(ts)
    assert sc.last_route[0] == "full"
    assert len(got) > 0
    assert_tables_equal(got, tt)
    assert_tables_equal(got, jt, skip=("psm_id",))


@pytest.mark.parametrize("shape", [(1, 2), (2, 2)])
def test_chimera(dbs, shape):
    """Chimeric search (report_psms 2): the grid rescores the candidates
    with each round's peaks removed; equal to both single-device
    Scorers, second-rank PSMs included."""
    single = _spectra_arrays(dbs[1], 9, [2], seed=8, noise=0)
    # spectrum k: its own peptide's ions and, at a tenth of their
    # intensity, spectrum k + 1's
    arrays = []
    for a, b in zip(single[:-1], single[1:]):
        m = np.concatenate([a["masses"], b["masses"]])
        v = np.concatenate([a["intens"], b["intens"] * np.float32(0.1)])
        order = np.argsort(m, kind="stable")
        arrays.append(dict(a, masses=m[order], intens=v[order]))
    (jp, js), (tp, ts) = _both(dbs, arrays, prec=("da", -500.0, 500.0),
                               chimera=True, min_matched_peaks=1,
                               min_isotope_err=0, max_isotope_err=0)
    got = tshard.ShardedScorer(dbs[1], _mesh(shape), tp).score_table(ts)
    tt = tsearch.Scorer(dbs[1], tp, device="cpu").score_table(
        _spectra(tproc, arrays))
    jt = jsearch.Scorer(dbs[0], jp).score_table(js)
    assert (got.columns["rank"] == 2).any()
    assert_tables_equal(got, tt)
    assert_tables_equal(got, jt)


def test_score_stream_matches_score_table(dbs, narrow_case):
    """score_stream (two batches in flight) equals score_table on each
    batch."""
    arrays, tp, _tt, _jt = narrow_case
    mesh = _mesh((2, 2))
    cuts = [arrays[:10], [], arrays[10:]]
    streamed = list(tshard.ShardedScorer(dbs[1], mesh, tp).score_stream(
        [_spectra(tproc, a) for a in cuts]))
    one = tshard.ShardedScorer(dbs[1], mesh, tp)
    assert len(streamed) == 3 and len(streamed[1]) == 0
    for t, a in zip(streamed, cuts):
        assert_tables_equal(t, one.score_table(_spectra(tproc, a)))


# ----------------------------------------------------------------------
# make_mesh and the Runner
# ----------------------------------------------------------------------


def test_make_mesh():
    mesh = _mesh((2, 2))
    assert mesh.shape == {"data": 2, "model": 2}
    assert all(d.type == "cpu" for row in mesh.devices for d in row)
    with pytest.raises(ValueError, match="need 4 devices, have 3"):
        tshard.make_mesh(2, 2, devices=["cpu"] * 3)
    # asked for the CPU, this process's devices are its one CPU
    assert tshard.local_devices("cpu") == [tshard.torch.device("cpu")]
    with pytest.raises(ValueError, match="need 2 devices, have 1"):
        tshard.make_mesh(2, 1, devices=tshard.local_devices("cpu"))


def test_mesh_without_card_raises(monkeypatch):
    """By default the grid is the cards: with none, make_mesh and
    local_devices raise rather than fall back to the CPU."""
    monkeypatch.setattr(tshard.torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tshard.local_devices()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tshard.make_mesh(1, 1)


def _runner(cfg, outdir, **kw):
    from sage_tpu_torch.pipeline.input import build_search
    from sage_tpu_torch.pipeline.runner import Runner

    return Runner(build_search(cfg, output_directory=str(outdir), **kw),
                  device="cpu")


@pytest.fixture
def four_cpus(monkeypatch):
    """This process "sees" four devices: the CPU four times."""
    monkeypatch.setattr(tshard, "local_devices",
                        lambda device="cuda": [tshard.torch.device("cpu")] * 4)


@pytest.fixture(scope="module")
def runner_inputs(tmp_path_factory):
    from test_torch_runner import _fasta, _raw_spectra, _write_mzml

    d = tmp_path_factory.mktemp("mesh_runner")
    text = _fasta(16, 300, seed=41)
    (d / "db.fasta").write_text(text)
    _write_mzml(d / "run.mzML", _raw_spectra(text, 48, seed=43))
    return d


def _runner_config(d, **extra):
    import json

    from test_torch_runner import CONFIG

    cfg = json.loads(json.dumps(CONFIG))
    cfg["database"]["fasta"] = str(d / "db.fasta")
    cfg["mzml_paths"] = [str(d / "run.mzML")]
    cfg.update(extra)
    return cfg


@pytest.mark.parametrize("mode", ["standard", "chimera", "annotate"])
def test_runner_mesh_matches_single_device(runner_inputs, tmp_path,
                                           monkeypatch, four_cpus, mode):
    """The Runner on a (2, 2) grid: results.sage.tsv byte-equal to the
    single-device run's, psm_id included, and with annotate_matches
    matched_fragments.sage.tsv too."""
    extra = {"annotate_matches": mode == "annotate"}
    if mode == "chimera":
        extra.update(chimera=True, report_psms=2)
    cfg = _runner_config(runner_inputs, **extra)
    monkeypatch.delenv("SAGE_TPU_MESH", raising=False)
    names = ["results.sage.tsv"] + (
        ["matched_fragments.sage.tsv"] if mode == "annotate" else [])
    out = {}
    for key, shape in (("single", (1, 1)), ("mesh", (2, 2))):
        r = _runner(cfg, tmp_path / key, mesh_shape=shape)
        kinds = []
        real = r._make_scorer

        def spy():
            s = real()
            kinds.append(type(s).__name__)
            return s

        r._make_scorer = spy
        r.run()
        assert kinds == ["Scorer" if key == "single" else "ShardedScorer"]
        out[key] = [(tmp_path / key / n).read_bytes() for n in names]
    assert out["single"] == out["mesh"]
    assert out["single"][0].count(b"\n") > 20
    if mode == "annotate":
        assert out["single"][1].count(b"\n") > 20


def test_table_shards_share_a_device(dbs):
    """Shards of one model column on one device share its ladders; the
    P_pad rule is sage_tpu's."""
    tab = tshard.ShardedTables(dbs[1], _mesh((2, 2)), ("b", "y"), 2)
    assert tab.shards[0][0] is tab.shards[1][0]
    assert tab.shards[0][0] is not tab.shards[0][1]
    jt = jshard.ShardedTables.shard(dbs[0], jshard.make_mesh(1, 2))
    assert (tab.P_pad, tab.P_local) == (jt.P_pad, jt.P_pad // 2)
