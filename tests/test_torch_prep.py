"""The batch prep of the port's search (``Scorer._prep``: the columnar
pass, the host's window bounds and ``batch_prep``) against the host's
whole prep (``Scorer._pad_peaks`` and ``Scorer._expand_rows``, the
port's and sage_tpu's), bit for bit, on the CPU where ``batch_prep``
takes its plain version; and the search through it against the search
through the host's prep."""

import dataclasses

import jax  # noqa: F401  (conftest keeps JAX on the CPU)
import numpy as np
import pytest
import torch

import sage_tpu.chem.fasta as jfasta
import sage_tpu.chem.mass as jmass
import sage_tpu.index.builder as jbuilder
import sage_tpu.ops.search as jsearch
import sage_tpu.spectrum.processor as jproc
from sage_tpu_torch.bench_baseline import synth_fasta, synth_spectra
from sage_tpu_torch.chem.fasta import Fasta
from sage_tpu_torch.chem.mass import PROTON, Tolerance
from sage_tpu_torch.index.builder import DatabaseParams
from sage_tpu_torch.ops import batch_prep as tprep
from sage_tpu_torch.ops.batch_prep import BatchColumns
from sage_tpu_torch.ops.search import Scorer, SearchParams
from sage_tpu_torch.spectrum.processor import Precursor
from sage_tpu_torch.utils import trace

F32 = np.float32


@pytest.fixture(scope="module")
def db():
    params = DatabaseParams()
    return params.build(Fasta.parse(synth_fasta(80), params.decoy_tag, True))


@pytest.fixture(scope="module")
def jdb():
    """sage_tpu's database of the same FASTA text."""
    params = jbuilder.DatabaseParams()
    return params.build(jfasta.Fasta.parse(synth_fasta(80), params.decoy_tag,
                                           True))


def _jax_scorer(jdb, params):
    """sage_tpu's Scorer with the port's SearchParams ``params``."""
    kw = {f.name: getattr(params, f.name)
          for f in dataclasses.fields(jsearch.SearchParams)}
    for k in ("precursor_tol", "fragment_tol"):
        t = kw[k]
        kw[k] = jmass.Tolerance(t.kind, t.lo, t.hi)
    return jsearch.Scorer(jdb, jsearch.SearchParams(**kw))


def _jax_spectra(spectra):
    """The port's spectra as sage_tpu's ProcessedSpectrum objects."""
    return [
        jproc.ProcessedSpectrum(
            level=s.level, id=s.id, file_id=s.file_id,
            scan_start_time=s.scan_start_time,
            ion_injection_time=s.ion_injection_time,
            precursors=[jproc.Precursor(mz=p.mz, charge=p.charge)
                        for p in s.precursors],
            masses=s.masses.copy(), intensities=s.intensities.copy(),
            mobilities=s.mobilities.copy(),
            total_ion_current=s.total_ion_current,
        )
        for s in spectra
    ]


def _params(**kw):
    base = dict(precursor_tol=Tolerance("ppm", -20.0, 20.0),
                fragment_tol=Tolerance("ppm", -10.0, 10.0),
                min_isotope_err=-1, max_isotope_err=3, report_psms=2,
                min_matched_peaks=2)
    base.update(kw)
    return SearchParams(**base)


def _exact_mz(mass, z=1):
    """An f32 precursor m/z whose ``(f32(mz) - PROTON) * z`` is ``mass``
    exactly (the f32 ops of the window's center), found by ulp steps."""
    mass = F32(mass)
    x = F32(F32(mass / F32(z)) + PROTON)
    for _ in range(64):
        got = F32(F32(x - PROTON) * F32(z))
        if got == mass:
            return float(x)
        x = np.nextafter(x, F32(np.inf) if got < mass else F32(-np.inf))
    raise AssertionError(f"no f32 m/z gives {mass!r}")


def _spectra(db, case):
    spectra = synth_spectra(db, 48, seed=3)
    for i, s in enumerate(spectra):
        s.precursors[0].charge = (2, 3, None)[i % 3]
    mono = db.table.mono
    if case == "empty_spectrum":
        spectra[5].masses = np.zeros(0, F32)
        spectra[5].intensities = np.zeros(0, F32)
    if case == "pk_multiple_32":
        for s in spectra:
            s.masses, s.intensities = s.masses[:50], s.intensities[:50]
        spectra[7].masses = np.sort(np.resize(spectra[7].masses, 64))
        spectra[7].intensities = np.resize(spectra[7].intensities, 64)
    if case == "ties":
        # zero-width windows centred on peptide masses: each row's bounds
        # equal a mass of the table (duplicated masses among them)
        dup = np.flatnonzero(mono[1:] == mono[:-1])
        picks = np.r_[dup[:8], dup[:8] + 1,
                      np.linspace(0, mono.size - 1, 32).astype(int)]
        assert picks.size == len(spectra)
        for s, k in zip(spectra, picks):
            s.precursors[0] = Precursor(mz=_exact_mz(mono[k]), charge=1)
    if case == "off_ends":
        for i, s in enumerate(spectra[:12]):
            s.precursors[0] = Precursor(
                mz=(50.0 + i) if i % 2 else 9000.0 + i, charge=1 + i % 2)
    return spectra


# case -> SearchParams changes
_CASES = {
    "ppm": {},
    "da_iso_0": dict(precursor_tol=Tolerance("da", -0.5, 0.5),
                     min_isotope_err=0, max_isotope_err=0),
    "overridden": dict(override_precursor_charge=True,
                       min_precursor_charge=2, max_precursor_charge=4),
    "empty_spectrum": {},
    "pk_multiple_32": {},
    "ties": dict(precursor_tol=Tolerance("da", 0.0, 0.0),
                 min_isotope_err=0, max_isotope_err=0),
    "off_ends": {},
}


@pytest.mark.parametrize("case", sorted(_CASES))
def test_prep_matches_host_prep(db, jdb, case):
    """``_prep`` gives ``_pad_peaks``'s padded masses and intensities and
    Pk, and ``_expand_rows``' si, z, iso, i0 and i1, bit for bit and
    dtype for dtype, without padding on the host, for the port's host
    prep and for sage_tpu's (whose peak axis adds 32 pad columns where
    it is a multiple of 128); ``batch_prep``'s plain version equals
    ``np.searchsorted`` on the rows' own bounds."""
    sc = Scorer(db, _params(**_CASES[case]), device="cpu")
    spectra = _spectra(db, case)
    pads = trace.counters().get("search.host_pad", 0)
    cols, peaks, rows = sc._prep(spectra)
    assert trace.counters().get("search.host_pad", 0) == pads
    masses, intens, Pk = sc._pad_peaks(spectra)
    host = sc._expand_rows(spectra)
    assert cols.Pk == Pk and peaks.shape == (2, len(spectra), Pk)
    if case == "pk_multiple_32":
        assert Pk == 64
    assert peaks.dtype == torch.float32
    np.testing.assert_array_equal(peaks[0].numpy().view(np.uint32),
                                  masses.view(np.uint32))
    np.testing.assert_array_equal(peaks[1].numpy().view(np.uint32),
                                  intens.view(np.uint32))
    assert list(rows) == list(host)
    for k in host:
        assert rows[k].dtype == host[k].dtype == np.int32, k
        np.testing.assert_array_equal(rows[k], host[k], err_msg=k)
    js = _jax_scorer(jdb, sc.params)
    jspectra = _jax_spectra(spectra)
    jm, ji, jPk = js._pad_peaks(jspectra)
    assert jPk == Pk + 32 * (Pk % 128 == 0)
    for got, want, pad in ((peaks[0], jm, np.inf), (peaks[1], ji, -1.0)):
        np.testing.assert_array_equal(got.numpy().view(np.uint32),
                                      want[:, :Pk].view(np.uint32))
        assert (want[:, Pk:] == pad).all()
    jrows = js._expand_rows(jspectra)
    assert list(rows) == list(jrows)
    for k in jrows:
        np.testing.assert_array_equal(rows[k], jrows[k], err_msg=k)
    w = sc._window_rows(cols.prec_mz, cols.prec_z)
    mono = db.table.mono
    if case == "ties":
        assert np.isin(w["lo"], mono).all() and np.isin(w["hi"], mono).all()
        assert (host["i1"] - host["i0"] >= 2).any()
    if case == "off_ends":
        assert (host["i1"] == 0).any() and (host["i0"] == mono.size).any()
    # the plain version on its own, on the rows' bounds and the ±inf,
    # NaN and mass-valued bounds beside them
    extra = np.r_[mono[[0, 3, -1]], -np.inf, np.inf, np.nan].astype(F32)
    lo = np.r_[w["lo"], extra]
    hi = np.r_[w["hi"], extra]
    flat_m = np.concatenate([s.masses for s in spectra]).astype(F32)
    flat_i = np.concatenate([s.intensities for s in spectra]).astype(F32)
    offs = np.r_[0, np.cumsum([len(s) for s in spectra])].astype(np.int32)
    _, i01 = tprep.batch_prep_plain(
        torch.from_numpy(flat_m), torch.from_numpy(flat_i),
        torch.from_numpy(offs), torch.from_numpy(lo), torch.from_numpy(hi),
        sc.tables.mono, P=sc.tables.P_real, Pk=Pk)
    np.testing.assert_array_equal(i01[0].numpy(),
                                  np.searchsorted(mono, lo, side="left"))
    np.testing.assert_array_equal(i01[1].numpy(),
                                  np.searchsorted(mono, hi, side="right"))


def _host_prep(sc):
    """``_prep`` as the host did it: ``_pad_peaks``, one upload and
    ``_expand_rows``."""

    def prep(spectra):
        masses, intens, _Pk = sc._pad_peaks(spectra)
        return (BatchColumns(spectra), sc._peaks_device(masses, intens),
                sc._expand_rows(spectra))

    return prep


# path -> (environment, SearchParams changes, host pads a batch)
_PATHS = {
    "narrow_fused": ({}, {}, False),
    "annotated": ({}, dict(annotate_matches=True), True),
    "open": ({"SAGE_TPU_OPEN_THRESHOLD": "1"},
             dict(precursor_tol=Tolerance("da", -500.0, 100.0)), True),
    "two_dispatch": ({"SAGE_TPU_FUSED": "0"}, {}, True),
}


@pytest.mark.parametrize("path", sorted(_PATHS))
def test_stream_matches_table_and_host_prep(db, monkeypatch, path):
    """``score_stream`` equals ``score_table`` and the search through the
    host's prep column by column (the psm ids aside), on the narrow fused
    path, with annotations, on the open path and on the two-dispatch
    path; the host pads only where a path reads its padded peaks."""
    env, kw, pads = _PATHS[path]
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    params = _params(**kw)
    spectra = synth_spectra(db, 96, seed=8)
    for i, s in enumerate(spectra):
        s.precursors[0].charge = (2, 3, None)[i % 3]
    batches = [spectra[:40], spectra[40:41], spectra[41:]]
    before = trace.counters().get("search.host_pad", 0)
    streamed = list(Scorer(db, params, device="cpu").score_stream(batches))
    grew = trace.counters().get("search.host_pad", 0) - before
    assert (grew > 0) == pads, grew
    tabled = [Scorer(db, params, device="cpu").score_table(b)
              for b in batches]
    host = Scorer(db, params, device="cpu")
    monkeypatch.setattr(host, "_prep", _host_prep(host))
    hosted = list(host.score_stream(batches))
    assert sum(len(t) for t in streamed) > len(spectra)
    for st, tt, ht in zip(streamed, tabled, hosted):
        for other in (tt, ht):
            assert st.spec_ids == other.spec_ids
            for k in st.columns:
                if k == "psm_id":
                    continue
                np.testing.assert_array_equal(
                    st.columns[k], other.columns[k], err_msg=k)
            if params.annotate_matches:
                assert [dataclasses.asdict(f) for f in st.fragments] == \
                    [dataclasses.asdict(f) for f in other.fragments]


def test_columns_read_every_field(db):
    """``BatchColumns`` reads the fields ``_emit_table`` reported from the
    spectra: f32 rt, TIC and ion mobility (0 where absent), i32 file id,
    the ids, the precursor m/z and charge (0 where absent); a spectrum
    without a precursor is refused."""
    spectra = synth_spectra(db, 6, seed=4)
    spectra[1].precursors[0].charge = None
    spectra[2].precursors[0].inverse_ion_mobility = 0.875
    spectra[3].file_id = 7
    cols = BatchColumns(spectra)
    assert cols.ids == [s.id for s in spectra]
    assert cols.prec_z.tolist() == [2, 0, 2, 2, 2, 2]
    np.testing.assert_array_equal(
        cols.ims, np.array([0, 0, 0.875, 0, 0, 0], F32))
    np.testing.assert_array_equal(cols.file_id, [0, 0, 0, 7, 0, 0])
    for name, attr in (("rt", "scan_start_time"),
                       ("tic", "total_ion_current")):
        np.testing.assert_array_equal(
            getattr(cols, name),
            np.array([getattr(s, attr) for s in spectra], F32))
    np.testing.assert_array_equal(
        cols.prec_mz, np.array([F32(s.precursors[0].mz) for s in spectra]))
    assert cols.lens.tolist() == [len(s) for s in spectra]
    spectra[4].precursors = []
    with pytest.raises(ValueError, match="missing MS1 precursor"):
        BatchColumns(spectra)
