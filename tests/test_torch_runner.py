"""The PyTorch port's Runner and CLI against sage_tpu's on the CPU.

The test writes a small FASTA and synthetic mzML / MGF files (spectra
drawn from the database's b/y ladders plus noise, from a seed); both
Runners search them, rescore, control FDR and write their outputs, and
the files must be byte-equal: ``results.sage.tsv``, ``results.sage.pin``,
``matched_fragments.sage.tsv`` and ``tmt.tsv``. ``results.json`` must be
equal once the output directory is normalised away."""

import base64
import functools
import json
import os
import zlib

import jax  # noqa: F401  (conftest keeps JAX on the CPU)
import numpy as np
import pytest
import torch

from test_torch_search import _fasta

PROTON = 1.0072764

CONFIG = {
    "database": {
        "enzyme": {"missed_cleavages": 1, "min_len": 7, "max_len": 30},
        "static_mods": {"C": 57.0215},
        "variable_mods": {"M": [15.9949]},
    },
    "precursor_tol": {"ppm": [-20, 20]},
    "fragment_tol": {"ppm": [-10, 10]},
    "isotope_errors": [-1, 1],
    "report_psms": 2,
    "min_peaks": 10,
    "write_pin": True,
    "annotate_matches": True,
}

TMT6 = [126.127726, 127.124761, 128.134436, 129.131471, 130.141145,
        131.138180]


def _raw_spectra(fasta_text, n, seed):
    """``n`` spectra as dicts (id, rt, precursor m/z and charge, peak m/z
    and intensities): 80% of a peptide's singly charged b/y ions plus 20
    noise peaks; every fourth spectrum is noise only."""
    from sage_tpu.chem.fasta import Fasta
    from sage_tpu.index.builder import DatabaseParams

    dbp = DatabaseParams.from_config(CONFIG["database"])
    db = dbp.build(Fasta.parse(fasta_text, dbp.decoy_tag, True))
    b, y = db.table.ladders()
    targets = np.flatnonzero(~db.table.decoy & (db.table.lens >= 8))
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        p = int(targets[rng.integers(0, targets.size)])
        k = int(db.table.lens[p]) - 1
        frags = np.concatenate([b[p, :k], y[p, :k]]).astype(np.float64)
        if i % 4 == 3:
            frags = frags[:0]
        frags = frags[rng.random(frags.size) < 0.8] + PROTON
        noise = rng.uniform(150.0, 1800.0, 20)
        mz = np.sort(np.concatenate([frags, noise]))
        z = 2 + (i % 3 == 0)
        out.append({
            "id": f"scan={i + 1}", "rt": 0.5 + 0.25 * i,
            "prec_mz": float(db.table.mono[p]) / z + PROTON, "charge": z,
            "mz": mz, "int": rng.uniform(1e3, 1e6, mz.size),
        })
    return out


def _enc(arr, dtype):
    return base64.b64encode(
        zlib.compress(np.asarray(arr, dtype).tobytes())
    ).decode()


def _write_mzml(path, spectra):
    parts = ['<?xml version="1.0"?><mzML><run><spectrumList>']
    for s in spectra:
        parts.append(
            f'<spectrum id="{s["id"]}">'
            '<cvParam accession="MS:1000511" value="2"/>'
            '<cvParam accession="MS:1000127" value=""/>'
            f'<cvParam accession="MS:1000285" value="{float(s["int"].sum())}"/>'
            "<scanList><scan>"
            f'<cvParam accession="MS:1000016" value="{s["rt"]}" '
            'unitAccession="UO:0000031"/>'
            "</scan></scanList><precursorList><precursor>"
            "<selectedIonList><selectedIon>"
            f'<cvParam accession="MS:1000744" value="{s["prec_mz"]}"/>'
            f'<cvParam accession="MS:1000041" value="{s["charge"]}"/>'
            "</selectedIon></selectedIonList></precursor></precursorList>"
            "<binaryDataArrayList>"
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


def _write_mgf(path, spectra):
    lines = []
    for s in spectra:
        lines += ["BEGIN IONS", f"TITLE={s['id']}",
                  f"PEPMASS={s['prec_mz']!r}", f"CHARGE={s['charge']}+",
                  f"RTINSECONDS={60.0 * s['rt']!r}"]
        lines += [f"{float(m)!r} {float(np.float32(v))!r}"
                  for m, v in zip(s["mz"], s["int"])]
        lines.append("END IONS")
    path.write_text("\n".join(lines) + "\n")


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    d = tmp_path_factory.mktemp("runner_inputs")
    text = _fasta(16, 300, seed=41)
    (d / "db.fasta").write_text(text)
    spectra = _raw_spectra(text, 48, seed=43)
    _write_mzml(d / "run.mzML", spectra)
    _write_mgf(d / "run.mgf", spectra)
    # the same MS2 spectra with TMT6 reporter peaks
    rng = np.random.default_rng(45)
    tmt = []
    for s in spectra[:24]:
        rep = rng.uniform(1e4, 1e6, len(TMT6))
        order = np.argsort(np.concatenate([TMT6, s["mz"]]))
        tmt.append(dict(s, mz=np.concatenate([TMT6, s["mz"]])[order],
                        int=np.concatenate([rep, s["int"]])[order]))
    _write_mzml(d / "tmt.mzML", tmt)
    return d


def _config(inputs, name, **extra):
    cfg = json.loads(json.dumps(CONFIG))
    cfg["database"]["fasta"] = str(inputs / "db.fasta")
    cfg["mzml_paths"] = [str(inputs / name)]
    for k, v in extra.items():
        if k == "database":
            cfg["database"].update(v)
        else:
            cfg[k] = v
    return cfg


def _run(pkg, cfg, outdir):
    """One Runner run; returns run()'s result without the FeatureTable."""
    if pkg == "jax":
        from sage_tpu.pipeline.input import build_search
        from sage_tpu.pipeline.runner import Runner

        runner = Runner(build_search(cfg, output_directory=str(outdir)))
    else:
        from sage_tpu_torch.pipeline.input import build_search
        from sage_tpu_torch.pipeline.runner import Runner

        runner = Runner(build_search(cfg, output_directory=str(outdir)),
                        device="cpu")
    return {k: v for k, v in runner.run().items()
            if k not in ("features", "run_time", "phases")}


def _results_json(outdir):
    with open(os.path.join(outdir, "results.json")) as f:
        d = json.load(f)
    d["output_paths"] = [os.path.basename(p) for p in d["output_paths"]]
    return d


def _assert_same_outputs(a, b, names):
    for name in names:
        with open(os.path.join(a, name), "rb") as fa, \
                open(os.path.join(b, name), "rb") as fb:
            assert fa.read() == fb.read(), name
    assert _results_json(a) == _results_json(b)


RUNS = {
    "mzml": dict(name="run.mzML"),
    "mgf": dict(name="run.mgf"),
    "tmt": dict(name="tmt.mzML", extra=dict(
        quant={"tmt": "Tmt6", "tmt_settings": {"level": 2}},
        deisotope=False)),
    "prefilter_low_memory": dict(name="run.mzML", extra=dict(database={
        "prefilter": True, "prefilter_low_memory": True,
        "prefilter_chunk_size": 5})),
    "prefilter": dict(name="run.mzML", extra=dict(database={
        "prefilter": True, "prefilter_low_memory": False,
        "prefilter_chunk_size": 5})),
}


@pytest.fixture(scope="module")
def runs(inputs, tmp_path_factory):
    """Every RUNS entry through both Runners, once per module:
    {run: (jax outdir, jax result, port outdir, port result)}."""
    out = {}
    for key, r in RUNS.items():
        cfg = _config(inputs, r["name"], **r.get("extra", {}))
        jd = tmp_path_factory.mktemp(f"jax_{key}")
        td = tmp_path_factory.mktemp(f"port_{key}")
        out[key] = (jd, _run("jax", cfg, jd), td, _run("port", cfg, td))
    return out


@pytest.mark.parametrize("run", sorted(RUNS))
def test_runner_outputs_byte_equal(runs, run):
    """Both Runners write byte-equal TSV, PIN and fragment files (and
    tmt.tsv on the TMT run), equal results.json, and return equal FDR
    counts."""
    jd, jres, td, tres = runs[run]
    names = ["results.sage.tsv", "results.sage.pin",
             "matched_fragments.sage.tsv"]
    if run == "tmt":
        names.append("tmt.tsv")
    _assert_same_outputs(jd, td, names)
    assert jres == tres
    with open(os.path.join(td, "results.sage.tsv")) as f:
        rows = [ln.split("\t") for ln in f.read().splitlines()[1:]]
    # a real search: the spectra drawn from peptides match targets (on
    # this few PSMs no q-value reaches 1%, so the counts at 1% are 0)
    assert sum(r[9] == "1" and r[8] == "1" for r in rows) >= 15
    if run == "tmt":
        with open(os.path.join(td, "tmt.tsv")) as f:
            assert len(f.read().splitlines()) == 25


def _cli_config(inputs, tmp_path):
    path = tmp_path / "config.json"
    path.write_text(json.dumps(_config(inputs, "run.mzML")))
    return str(path)


def test_cli_in_process_matches_sage_tpu(inputs, runs, tmp_path,
                                         monkeypatch):
    """``cli.main`` with the Runner's device set to the CPU writes the
    same files as sage_tpu's Runner on the same config."""
    import sage_tpu_torch.cli as cli
    import sage_tpu_torch.pipeline.runner as runner_mod

    monkeypatch.setattr(runner_mod, "Runner",
                        functools.partial(runner_mod.Runner, device="cpu"))
    out = tmp_path / "out"
    assert cli.main([_cli_config(inputs, tmp_path), "-o", str(out),
                     "--disable-telemetry-i-dont-want-to-improve-sage"]) == 0
    jd = runs["mzml"][0]
    _assert_same_outputs(jd, out, ["results.sage.tsv", "results.sage.pin",
                                   "matched_fragments.sage.tsv"])


def test_cli_without_cuda_fails(inputs, tmp_path, monkeypatch):
    """With no CUDA device and nothing set to the CPU, the CLI fails with
    the "no CUDA device" error and writes nothing, rather than running on
    the CPU."""
    import sage_tpu_torch.cli as cli

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    out = tmp_path / "out"
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main([_cli_config(inputs, tmp_path), "-o", str(out)])
    assert not os.path.exists(out / "results.sage.tsv")
