"""The port's chimeric search against sage_tpu on the CPU.

tests/test_chimera.py's setup (a spectrum made of two peptides' ladders)
and the wide synthetic batch of tests/test_search_golden.py go through
both packages' Scorers with ``chimera=True``; every FeatureTable column
must be equal, element for element, and the Runners' TSV byte-equal."""

import json

import jax  # noqa: F401  (conftest keeps JAX on the CPU)
import numpy as np
import pytest

import sage_tpu.chem.fasta as jfasta
import sage_tpu.chem.mass as jmass
import sage_tpu.index.builder as jbuilder
import sage_tpu.ops.search as jsearch
import sage_tpu.spectrum.processor as jproc
import sage_tpu_torch.chem.fasta as tfasta
import sage_tpu_torch.chem.mass as tmass
import sage_tpu_torch.index.builder as tbuilder
import sage_tpu_torch.ops.search as tsearch
import sage_tpu_torch.spectrum.processor as tproc
from test_torch_narrow_banded import wide_setup
from test_torch_runner import (
    CONFIG, _assert_same_outputs, _raw_spectra, _run, _write_mzml,
)
from test_torch_search import _build, _fasta, _params, _spectra, assert_tables_equal

FASTA = (">sp|A|A_TEST first\nMKWVTFISLLLLFSSAYSRGVFRRDTHKSEIAHRFKDLGE\n"
         ">sp|B|B_TEST second\nPEPTIDEKRILLKMEPTIDEKRAGEILK\n")


@pytest.fixture(scope="module")
def dbs():
    return _build(jfasta, jbuilder, FASTA), _build(tfasta, tbuilder, FASTA)


def _ions(db, i):
    b, y = db.table.ladders()
    n = int(db.table.lens[i]) - 1
    return np.concatenate([b[i, :n], y[i, :n]])


def _one(masses, intens, prec_mz, charge=2):
    order = np.argsort(masses, kind="stable")
    return [{"masses": np.asarray(masses, np.float32)[order],
             "intens": np.asarray(intens, np.float32)[order],
             "charge": charge, "mz": float(prec_mz)}]


def _both(dbs, arrays, prec, frag, **kw):
    """sage_tpu's and the port's tables of one batch."""
    jdb, tdb = dbs
    js = jsearch.Scorer(jdb, _params(jsearch, jmass, prec, frag, **kw))
    ts = tsearch.Scorer(tdb, _params(tsearch, tmass, prec, frag, **kw),
                        device="cpu")
    return (js.score_table(_spectra(jproc, arrays)),
            ts.score_table(_spectra(tproc, arrays)))


def test_chimera_finds_second_peptide(dbs):
    """Two co-isolated peptides: after the best PSM's peaks are removed
    the second round finds the other peptide, in both packages."""
    jdb = dbs[0]
    targets = np.flatnonzero(~jdb.table.decoy & (jdb.table.lens >= 8))
    i, j = int(targets[0]), int(targets[-1])
    fi, fj = _ions(jdb, i), _ions(jdb, j)
    arrays = _one(np.concatenate([fi, fj]),
                  np.concatenate([np.full(fi.shape, 1000.0),
                                  np.full(fj.shape, 100.0)]),
                  float(jdb.table.mono[i]) / 2 + jmass.PROTON)
    jt, tt = _both(dbs, arrays, ("da", -5000.0, 5000.0), ("ppm", -10.0, 10.0),
                   min_matched_peaks=4, chimera=True, report_psms=2)
    assert len(tt) == 2
    assert {int(x) for x in tt.columns["peptide_idx"]} == {i, j}
    assert sorted(int(x) for x in tt.columns["rank"]) == [1, 2]
    assert_tables_equal(jt, tt)


def test_chimera_equals_standard_for_clean_spectrum(dbs):
    """One peptide's ions with report_psms=1: chimera mode gives the
    standard search's PSM, in both packages."""
    jdb = dbs[0]
    i = int(np.flatnonzero(~jdb.table.decoy & (jdb.table.lens >= 8))[0])
    fi = _ions(jdb, i)
    arrays = _one(fi, np.full(fi.shape, 500.0),
                  float(jdb.table.mono[i]) / 2 + jmass.PROTON)
    prec, frag = ("ppm", -20.0, 20.0), ("ppm", -10.0, 10.0)
    jt, tt = _both(dbs, arrays, prec, frag, chimera=True)
    _j, t_std = _both(dbs, arrays, prec, frag)
    assert len(tt) == len(t_std) == 1
    for k in ("peptide_idx", "matched_peaks", "hyperscore", "charge"):
        np.testing.assert_array_equal(tt.columns[k], t_std.columns[k])
    assert_tables_equal(jt, tt)


WIDE_PREC = ("da", -500.0, 500.0)


@pytest.fixture(scope="module")
def wide():
    """The wide synthetic batch made chimeric: spectrum k holds its own
    peaks and, at a tenth of their intensity, those of spectrum k + 1;
    its precursor stays its own peptide's."""
    jdb, tdb, single = wide_setup(rng_seed=7, n_spec=9)
    arrays = []
    for a, b in zip(single[:-1], single[1:]):
        m = np.concatenate([a["masses"], b["masses"]])
        v = np.concatenate([a["intens"], b["intens"] * np.float32(0.1)])
        arrays += _one(m, v, a["mz"])
    return (jdb, tdb), arrays


@pytest.mark.parametrize("report_psms", [2, 3])
def test_chimera_rounds_match_sage_tpu(wide, report_psms):
    """Several rounds on the chimeric wide batch (±500 Da windows): every
    column equal, ranks numbered per spectrum from 1."""
    dbs_w, arrays = wide
    jt, tt = _both(dbs_w, arrays, WIDE_PREC, ("ppm", -10.0, 10.0),
                   min_matched_peaks=1, chimera=True,
                   report_psms=report_psms)
    assert tt.columns["rank"].max() == report_psms
    assert_tables_equal(jt, tt)


def test_chimera_stream_equals_table(wide):
    """``score_stream`` over two batches gives ``score_table``'s tables."""
    (_jdb, tdb), arrays = wide
    params = _params(tsearch, tmass, WIDE_PREC, ("ppm", -10.0, 10.0),
                     min_matched_peaks=1, chimera=True, report_psms=2)
    batches = [_spectra(tproc, arrays[:5]), _spectra(tproc, arrays[5:])]
    streamed = list(tsearch.Scorer(tdb, params, device="cpu")
                    .score_stream(batches))
    ts = tsearch.Scorer(tdb, params, device="cpu")
    for got, b in zip(streamed, batches):
        assert_tables_equal(got, ts.score_table(b))


def test_chimera_runners_byte_equal(tmp_path):
    """Both Runners with ``chimera: true`` write byte-equal TSV and PIN
    files and return equal FDR counts."""
    text = _fasta(16, 300, seed=41)
    (tmp_path / "db.fasta").write_text(text)
    raw = _raw_spectra(text, 33, seed=47)
    # spectrum k carries spectrum k + 1's peaks too, at a third of their
    # intensity
    chim = []
    for a, b in zip(raw[:-1], raw[1:]):
        mz = np.concatenate([a["mz"], b["mz"]])
        order = np.argsort(mz, kind="stable")
        chim.append(dict(a, mz=mz[order], int=np.concatenate(
            [a["int"], b["int"] / 3.0])[order]))
    _write_mzml(tmp_path / "run.mzML", chim)
    cfg = json.loads(json.dumps(CONFIG))
    cfg["database"]["fasta"] = str(tmp_path / "db.fasta")
    cfg["mzml_paths"] = [str(tmp_path / "run.mzML")]
    cfg.update(chimera=True, report_psms=2,
               precursor_tol={"da": [-500, 500]})
    jd, td = tmp_path / "jax", tmp_path / "port"
    jres, tres = _run("jax", cfg, jd), _run("port", cfg, td)
    assert jres == tres
    _assert_same_outputs(jd, td, ["results.sage.tsv", "results.sage.pin",
                                  "matched_fragments.sage.tsv"])
    with open(td / "results.sage.tsv") as f:
        lines = f.read().splitlines()
    col = lines[0].split("\t").index("rank")
    assert "2" in {ln.split("\t")[col] for ln in lines[1:]}


def test_remove_matched_is_sage_tpus(dbs):
    """The host peak removal marks the same peaks in both packages."""
    jdb, tdb = dbs
    i = int(np.flatnonzero(~jdb.table.decoy & (jdb.table.lens >= 8))[0])
    fi = _ions(jdb, i)
    rng = np.random.default_rng(5)
    masses = np.sort(np.concatenate(
        [fi, rng.uniform(150, 1500, 30)]).astype(np.float32))[None, :]
    intens = rng.uniform(1, 1e4, masses.shape).astype(np.float32)
    prec, frag = ("ppm", -20.0, 20.0), ("ppm", -10.0, 10.0)
    js = jsearch.Scorer(jdb, _params(jsearch, jmass, prec, frag))
    ts = tsearch.Scorer(tdb, _params(tsearch, tmass, prec, frag), device="cpu")
    rj = np.zeros(masses.shape, bool)
    rt = np.zeros(masses.shape, bool)
    js._remove_matched(0, i, 3, masses, intens, rj)
    ts._remove_matched(0, i, 3, masses, intens, rt)
    assert rt.sum() >= fi.size // 2
    np.testing.assert_array_equal(rj, rt)
