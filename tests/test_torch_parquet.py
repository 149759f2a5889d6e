"""The port's parquet output against sage_tpu's on the CPU.

Both Runners run with ``parquet=True`` on the synthetic inputs of
tests/test_torch_runner.py (an mzML with ``annotate_matches``, its TMT6
mzML) and tests/test_torch_lfq.py (two files with MS1 scans, with
``quant.lfq``). ``results.sage.parquet``, ``matched_fragments.sage.parquet``
and ``lfq.parquet`` must be byte-equal (the writer's metadata names the
same pyarrow in both, so the files' bytes can match and are compared
as bytes), the parquet set must replace the TSVs, and a parquet run
without pyarrow must fail with pyarrow's ImportError and write nothing.
Tolerance: exact.
"""

import json
import os
import sys

import jax  # noqa: F401  (conftest keeps JAX on the CPU)
import numpy as np
import pytest

pq = pytest.importorskip("pyarrow.parquet")

from test_torch_lfq import _lfq_files  # noqa: E402
from test_torch_runner import (  # noqa: E402,F401  (inputs: a fixture)
    CONFIG, TMT6, _config, _raw_spectra, _run, inputs,
)
from test_torch_search import _fasta  # noqa: E402

TSVS = ("results.sage.tsv", "matched_fragments.sage.tsv", "tmt.tsv",
        "lfq.tsv")


def _lfq_config(tmp):
    text = _fasta(24, 300, seed=51)
    (tmp / "db.fasta").write_text(text)
    cfg = json.loads(json.dumps(CONFIG))
    cfg["database"]["fasta"] = str(tmp / "db.fasta")
    cfg["mzml_paths"] = _lfq_files(text, tmp, 120, 400, seed=53)
    cfg.update(quant={"lfq": True, "lfq_settings": {"peptide_q_value": 0.05}},
               isotope_errors=[0, 0], report_psms=1)
    return cfg


@pytest.fixture(scope="module")
def parquet_runs(inputs, tmp_path_factory):  # noqa: F811
    """Both Runners with parquet=True on each case:
    {case: (jax outdir, jax result, port outdir, port result)}."""
    cfgs = {
        "mzml": _config(inputs, "run.mzML", parquet=True),
        "tmt": _config(inputs, "tmt.mzML", parquet=True, deisotope=False,
                       quant={"tmt": "Tmt6", "tmt_settings": {"level": 2}}),
        "lfq": dict(_lfq_config(tmp_path_factory.mktemp("lfq_in")),
                    parquet=True),
    }
    out = {}
    for case, cfg in cfgs.items():
        jd = tmp_path_factory.mktemp(f"jax_pq_{case}")
        td = tmp_path_factory.mktemp(f"port_pq_{case}")
        out[case] = (jd, _run("jax", cfg, jd), td, _run("port", cfg, td))
    return out


PARQUETS = {
    "mzml": ["results.sage.parquet", "matched_fragments.sage.parquet"],
    "tmt": ["results.sage.parquet", "matched_fragments.sage.parquet"],
    "lfq": ["results.sage.parquet", "matched_fragments.sage.parquet",
            "lfq.parquet"],
}


@pytest.mark.parametrize("case", sorted(PARQUETS))
def test_parquet_byte_equal(parquet_runs, case):
    """Every parquet file byte-equal to sage_tpu's, equal FDR counts; the
    parquet set replaces the TSVs (the PIN stays, as in sage_tpu)."""
    jd, jres, td, tres = parquet_runs[case]
    jres.pop("lfq"), tres.pop("lfq")
    assert jres == tres
    for name in PARQUETS[case]:
        with open(jd / name, "rb") as a, open(td / name, "rb") as b:
            assert a.read() == b.read(), name
        assert pq.read_table(td / name).num_rows > 0, name
    for d in (jd, td):
        assert not set(TSVS) & set(os.listdir(d)), os.listdir(d)
        assert os.path.exists(d / "results.sage.pin")
    with open(td / "results.json") as f:
        paths = [os.path.basename(p) for p in json.load(f)["output_paths"]]
    assert set(PARQUETS[case]) <= set(paths)


def test_parquet_schema(parquet_runs):
    """results.sage.parquet: the reference's 44 columns (45 with TMT's
    reporter list) and their types; matched_fragments and lfq in long
    format (lfq's charge null: the default combines charge states);
    ZSTD-compressed."""
    import pyarrow as pa

    td = parquet_runs["mzml"][2]
    res = pq.read_table(td / "results.sage.parquet")
    assert res.num_columns == 44
    assert res.schema.field("psm_id").type == pa.int64()
    assert res.schema.field("hyperscore").type == pa.float32()
    assert res.schema.field("is_decoy").type == pa.bool_()
    assert "reporter_ion_intensity" not in res.schema.names
    meta = pq.ParquetFile(td / "results.sage.parquet").metadata
    assert meta.row_group(0).column(0).compression == "ZSTD"
    frag = pq.read_table(td / "matched_fragments.sage.parquet")
    assert frag.schema.names == [
        "psm_id", "fragment_type", "fragment_ordinals", "fragment_charge",
        "fragment_mz_experimental", "fragment_mz_calculated",
        "fragment_intensity"]
    assert set(frag.column("psm_id").to_pylist()) <= set(
        res.column("psm_id").to_pylist())
    lfq = pq.read_table(parquet_runs["lfq"][2] / "lfq.parquet")
    assert lfq.schema.names == ["peptide", "stripped_peptide", "charge",
                                "proteins", "is_decoy", "q_value",
                                "filename", "intensity"]
    assert lfq.num_rows > 10
    assert lfq.column("charge").null_count == lfq.num_rows
    assert set(lfq.column("filename").to_pylist()) == {"run0.mzML",
                                                        "run1.mzML"}


def test_parquet_tmt_reporter_column(parquet_runs):
    """The nested reporter_ion_intensity float list: six channels, the
    reporter intensities written into each TMT spectrum (as f32)."""
    import pyarrow as pa

    td = parquet_runs["tmt"][2]
    res = pq.read_table(td / "results.sage.parquet")
    assert res.num_columns == 45
    assert res.schema.field("reporter_ion_intensity").type == pa.list_(
        pa.float32())
    # tests/test_torch_runner.py's TMT file: its first 24 spectra, each
    # with rng(45)'s six reporter intensities
    spectra = _raw_spectra(_fasta(16, 300, seed=41), 48, seed=43)
    rng = np.random.default_rng(45)
    written = {s["id"]: rng.uniform(1e4, 1e6, len(TMT6))
               for s in spectra[:24]}
    rows = res.select(["scannr", "reporter_ion_intensity"]).to_pylist()
    assert len(rows) >= 24
    for r in rows:
        np.testing.assert_array_equal(
            np.float32(r["reporter_ion_intensity"]),
            np.float32(written[r["scannr"]]))


def test_parquet_without_pyarrow_fails(inputs, tmp_path, monkeypatch):  # noqa: F811
    """With pyarrow unimportable a parquet run fails with ImportError and
    writes neither parquet nor TSV in its place."""
    monkeypatch.setitem(sys.modules, "pyarrow", None)
    monkeypatch.setitem(sys.modules, "pyarrow.parquet", None)
    out = tmp_path / "out"
    with pytest.raises(ImportError):
        _run("port", _config(inputs, "run.mzML", parquet=True), out)
    assert not [n for n in os.listdir(out)
                if n.endswith((".tsv", ".parquet"))], os.listdir(out)
