"""The port's label-free quant and HTML report against sage_tpu on the CPU.

tests/test_lfq.py's unit cases (isotope envelopes, the reference's
convolve, the RT grid and its traces) and its feature-map setup, rebuilt
on an in-test FASTA that holds LQSRPAAPPAPGPGQLTLR, go through both
packages; then both Runners search two synthetic mzML files whose MS1
scans carry the peptides' isotope envelopes over an elution profile and
must write byte-equal ``lfq.tsv``, ``results.sage.tsv`` and
``sage.report.html``. Tolerance: exact."""

import json
import os

import jax  # noqa: F401  (conftest keeps JAX on the CPU)
import numpy as np
import pytest

import sage_tpu.chem.isotopes as jiso
import sage_tpu.quant.lfq as jlfq
import sage_tpu_torch.chem.isotopes as tiso
import sage_tpu_torch.quant.lfq as tlfq
from test_torch_runner import CONFIG, _enc, _results_json, _run
from test_torch_search import _fasta

PROTON = 1.0072764
NEUTRON = 1.00335
GOLDEN = "LQSRPAAPPAPGPGQLTLR"
FASTA = (">sp|Q9TEST|LFQ_TEST lfq\nMSAGEKLQSRPAAPPAPGPGQLTLRAGTEPWKDLLSAER\n"
         ">sp|Q9TES2|LFQ_TES2 lfq\nMKTAYIAKQRQISFVKSHFSRQLEERLGLIEVQAPILSR\n")


def test_isotope_envelopes_match():
    """Both packages' envelopes, bit for bit, and the golden values
    (isotopes.rs:52-66)."""
    for c in (0, 1, 12, 60, 150, 400):
        for s in (0, 1, 5):
            np.testing.assert_array_equal(tiso.peptide_isotopes(c, s),
                                          jiso.peptide_isotopes(c, s))
    expected = np.array([0.3972, 0.2824, 0.1869]) / 0.3972
    assert np.all(np.abs(tiso.peptide_isotopes(60, 5) - expected) <= 0.02)


def _convolve_scalar(sl, kernel):
    """Direct port of lfq.rs:633-649."""
    n = len(kernel) - len(kernel) // 2
    out = []
    for idx in range(len(sl)):
        k = kernel[max(len(kernel) - (n + idx), 0):]
        w = sl[max(idx - (n - 1), 0):]
        out.append(sum(x * y for x, y in zip(w, k)))
    return np.array(out)


def test_convolve_and_kernel_match():
    """The smoothing kernel and the reference's convolve: equal to
    sage_tpu's, and to the scalar form within f64 rounding."""
    k = tlfq._gaussian_kernel(0.5, 10)
    np.testing.assert_array_equal(k, jlfq._gaussian_kernel(0.5, 10))
    assert np.isclose(k.sum(), 1.0) and np.allclose(k, k[::-1])
    sig = np.random.default_rng(3).random((4, 100))
    fast = tlfq._convolve_same(sig, k)
    np.testing.assert_array_equal(fast, jlfq._convolve_same(sig, k))
    assert np.allclose(fast[0], _convolve_scalar(sig[0], k), atol=1e-12)


def _grid(mod, settings_mod):
    dist = np.array([1.0, 0.5, 0.2], dtype=np.float32)
    g = mod.Grid(rt=0.5, file_id=0, distribution=dist, n_files=2)
    for k, drt in enumerate(np.linspace(-0.001, 0.001, 11)):
        for iso in range(3):
            g.add_entries([0.5 + drt], [iso], [k % 2],
                          [1000.0 * dist[iso] + 7.0 * iso + k])
    traces = g.summarize_traces()
    sa = traces.spectral_angle.copy()
    return g.matrix, sa, traces.integrate(settings_mod.LfqSettings())


def test_grid_traces_match():
    """The RT grid, its smoothed traces and the integrated peak of two
    files equal sage_tpu's."""
    import sage_tpu.pipeline.input as jinput
    import sage_tpu_torch.pipeline.input as tinput

    jm, jsa, (jpeak, jareas) = _grid(jlfq, jinput)
    tm, tsa, (tpeak, tareas) = _grid(tlfq, tinput)
    np.testing.assert_array_equal(jm, tm)
    np.testing.assert_array_equal(jsa, tsa)
    assert np.nanmax(tsa) > 0.95
    assert vars(jpeak) == vars(tpeak) and jareas == tareas
    assert tpeak.spectral_angle > 0.9 and min(tareas) > 0


def _lfq_setup(pkg):
    """tests/test_lfq.py's setup for one package: a one-PSM feature
    table on the golden peptide and 21 MS1 spectra carrying its charge-2
    envelope."""
    mods = {}
    for name in ("chem.fasta", "index.builder", "ml.retention_alignment",
                 "ops.features", "pipeline.input", "spectrum.processor",
                 "quant.lfq"):
        mods[name] = __import__(f"{pkg}.{name}", fromlist=["x"])
    params = mods["index.builder"].DatabaseParams()
    db = params.build(mods["chem.fasta"].Fasta.parse(FASTA, "rev_", True))
    pi = next(i for i, p in enumerate(db.peptides)
              if p.sequence == GOLDEN.encode())
    t = mods["ops.features"].FeatureTable.empty(1)
    c = t.columns
    c["peptide_idx"][0] = pi
    c["label"][0] = 1
    c["peptide_q"][0] = 0.001
    c["aligned_rt"][0] = 0.5
    c["calcmass"][0] = db.table.mono[pi]
    c["charge"][0] = 2
    t.spec_ids = ["x"]
    lfq = mods["quant.lfq"]
    fmap = lfq.build_feature_map(mods["pipeline.input"].LfqSettings(), (2, 3),
                                 db, t)
    mono = float(db.table.mono[pi])
    spectra = []
    for k, srt in enumerate(np.linspace(49.6, 50.4, 21)):
        masses = np.sort(np.array([(mono + i * NEUTRON) / 2.0
                                   for i in range(3)], np.float32))
        intens = np.array([1000.0, 700.0, 300.0], dtype=np.float32)
        spectra.append(mods["spectrum.processor"].ProcessedSpectrum(
            level=1, id=f"ms1={k}", file_id=0, scan_start_time=srt,
            ion_injection_time=0.0, precursors=[], masses=masses,
            intensities=intens, mobilities=np.zeros(0, np.float32),
            total_ion_current=np.float32(intens.sum()),
        ))
    align = [mods["ml.retention_alignment"].Alignment(
        file_id=0, max_rt=100.0, slope=1.0, intercept=0.0)]
    return lfq, db, fmap, spectra, align


@pytest.fixture(scope="module")
def lfq_setups():
    return _lfq_setup("sage_tpu"), _lfq_setup("sage_tpu_torch")


def test_feature_map_matches(lfq_setups):
    """1 peptide x charges {2, 3} x 3 isotopes x {target, decoy}; every
    array equal to sage_tpu's."""
    (_jl, _jdb, jf, *_), (_tl, _tdb, tf, *_) = lfq_setups
    assert tf.rt.size == 2 * 3 * 2
    assert (tf.rt[tf.decoy] < tf.rt[~tf.decoy].max()).all()
    for name in ("rt", "mass_lo", "mass_hi", "mobility_lo", "mobility_hi",
                 "charge", "isotope", "peptide", "file_id", "decoy",
                 "min_rts"):
        np.testing.assert_array_equal(getattr(jf, name), getattr(tf, name),
                                      err_msg=name)


def test_lfq_quantify_matches(lfq_setups):
    """The quantified peaks, areas and precursor q-values equal
    sage_tpu's; the target is found."""
    out = []
    for lfq, db, fmap, spectra, align in lfq_setups:
        areas = fmap.quantify(db, spectra, align)
        lfq.assign_precursor_q(areas)
        out.append({k: (vars(p), a) for k, (p, a) in areas.items()})
    assert out[0] == out[1]
    targets = [v for k, v in out[1].items() if not k[1]]
    assert targets and targets[0][1][0] > 0
    assert targets[0][0]["spectral_angle"] > 0.5


def _lfq_files(text, tmp_path, n_ms2, n_ms1, seed):
    """Two mzML files of ``n_ms2`` MS2 spectra drawn from 40 target
    peptides (80% of their singly charged b/y ions plus noise; every
    fifth spectrum noise only) and ``n_ms1`` MS1 scans carrying the
    peptides' charge-2 isotope envelopes over a Gaussian elution profile;
    the second file's retention times are shifted by 0.15 min."""
    from sage_tpu.chem.fasta import Fasta
    from sage_tpu.index.builder import DatabaseParams

    dbp = DatabaseParams.from_config(CONFIG["database"])
    db = dbp.build(Fasta.parse(text, dbp.decoy_tag, True))
    b, y = db.table.ladders()
    rng = np.random.default_rng(seed)
    cand = np.flatnonzero(~db.table.decoy & (db.table.lens >= 8))
    peps = rng.choice(cand, 40, replace=False)
    T = 20.0
    apex = rng.uniform(1.0, T - 1.0, peps.size)
    amp = rng.uniform(1e5, 1e7, peps.size)
    sigma = 0.1
    env = np.array([1.0, 0.62, 0.24])
    paths = []
    for f, shift in enumerate((0.0, 0.15)):
        frng = np.random.default_rng(seed + 1 + f)
        scans = []
        for i in range(n_ms2):
            j = i % peps.size
            p = int(peps[j])
            k = int(db.table.lens[p]) - 1
            frags = np.concatenate([b[p, :k], y[p, :k]]).astype(np.float64)
            if i % 5 == 4:
                frags = frags[:0]
            frags = frags[frng.random(frags.size) < 0.8] + PROTON
            mz = np.sort(np.concatenate([frags,
                                         frng.uniform(150.0, 1800.0, 20)]))
            scans.append({
                "level": 2, "rt": apex[j] + shift + frng.normal(0, 0.02),
                "prec_mz": float(db.table.mono[p]) / 2 + PROTON, "charge": 2,
                "mz": mz, "int": frng.uniform(1e3, 1e6, mz.size),
            })
        for k in range(n_ms1):
            rt = T * (k + 0.5) / n_ms1
            near = np.flatnonzero(np.abs(rt - apex - shift) < 4 * sigma)
            mz, it = [frng.uniform(350.0, 1500.0, 10)], [
                frng.uniform(1e2, 1e3, 10)]
            for j in near:
                h = amp[j] * np.exp(-0.5 * ((rt - apex[j] - shift) / sigma)
                                    ** 2)
                mono = float(db.table.mono[int(peps[j])])
                mz.append((mono + NEUTRON * np.arange(3)) / 2 + PROTON)
                it.append(h * env * frng.uniform(0.97, 1.03, 3))
            mz, it = np.concatenate(mz), np.concatenate(it)
            o = np.argsort(mz)
            scans.append({"level": 1, "rt": rt, "mz": mz[o], "int": it[o]})
        scans.sort(key=lambda s: s["rt"])
        path = tmp_path / f"run{f}.mzML"
        write_mzml_levels(path, scans)
        paths.append(str(path))
    return paths


def write_mzml_levels(path, scans):
    """MS1 and MS2 scans as mzML (MS2 with their precursor)."""
    parts = ['<?xml version="1.0"?><mzML><run><spectrumList>']
    for i, s in enumerate(scans):
        prec = "" if s["level"] == 1 else (
            "<precursorList><precursor><selectedIonList><selectedIon>"
            f'<cvParam accession="MS:1000744" value="{s["prec_mz"]}"/>'
            f'<cvParam accession="MS:1000041" value="{s["charge"]}"/>'
            "</selectedIon></selectedIonList></precursor></precursorList>")
        parts.append(
            f'<spectrum id="scan={i + 1}">'
            f'<cvParam accession="MS:1000511" value="{s["level"]}"/>'
            '<cvParam accession="MS:1000127" value=""/>'
            f'<cvParam accession="MS:1000285" value="{float(s["int"].sum())}"/>'
            "<scanList><scan>"
            f'<cvParam accession="MS:1000016" value="{s["rt"]}" '
            'unitAccession="UO:0000031"/></scan></scanList>' + prec
            + "<binaryDataArrayList>"
            '<binaryDataArray><cvParam accession="MS:1000523" value=""/>'
            '<cvParam accession="MS:1000574" value=""/>'
            '<cvParam accession="MS:1000514" value=""/>'
            f"<binary>{_enc(s['mz'], np.float64)}</binary></binaryDataArray>"
            '<binaryDataArray><cvParam accession="MS:1000521" value=""/>'
            '<cvParam accession="MS:1000574" value=""/>'
            '<cvParam accession="MS:1000515" value=""/>'
            f"<binary>{_enc(s['int'], np.float32)}</binary></binaryDataArray>"
            "</binaryDataArrayList></spectrum>"
        )
    parts.append("</spectrumList></run></mzML>")
    path.write_text("".join(parts))


def test_lfq_runners_byte_equal(tmp_path):
    """Both Runners with ``quant.lfq`` and ``write_report`` on two files:
    byte-equal lfq.tsv, results.sage.tsv and report (each run's output
    directory replaced by a placeholder), equal results.json; targets
    quantified."""
    text = _fasta(24, 300, seed=51)
    (tmp_path / "db.fasta").write_text(text)
    cfg = json.loads(json.dumps(CONFIG))
    cfg["database"]["fasta"] = str(tmp_path / "db.fasta")
    cfg["mzml_paths"] = _lfq_files(text, tmp_path, 120, 400, seed=53)
    # no decoy PSM: a peptide q-value is 1 / (target peptides), so the
    # ~30 peptides found need a 5% peptide cut to enter the feature map
    cfg.update(quant={"lfq": True, "lfq_settings": {"peptide_q_value": 0.05}},
               write_report=True, annotate_matches=False,
               isotope_errors=[0, 0], report_psms=1)
    jd, td = tmp_path / "jax", tmp_path / "port"
    jres, tres = _run("jax", cfg, jd), _run("port", cfg, td)
    lj, lt = jres.pop("lfq"), tres.pop("lfq")
    assert jres == tres
    assert {k: (vars(p), a) for k, (p, a) in lj.items()} == {
        k: (vars(p), a) for k, (p, a) in lt.items()}
    for name in ("results.sage.tsv", "results.sage.pin", "lfq.tsv"):
        with open(jd / name, "rb") as a, open(td / name, "rb") as b:
            assert a.read() == b.read(), name
    reports = []
    for d in (jd, td):
        with open(d / "sage.report.html") as f:
            reports.append(f.read().replace(str(d), "OUTDIR"))
    assert reports[0] == reports[1]
    assert _results_json(jd) == _results_json(td)
    with open(td / "lfq.tsv") as f:
        rows = f.read().splitlines()
    assert len(rows) > 10, rows[:3]
    assert any(float(r.split("\t")[3]) <= 0.05 for r in rows[1:])
    assert os.path.getsize(td / "sage.report.html") > 10000
