"""The port's Bruker timsTOF .d reader against sage_tpu's, and both
Runners on a synthetic ddaPASEF .d, on the CPU.

A small .d written here (sqlite metadata and tdf_bin frame blocks of
per-scan (TOF delta, intensity) pairs, as tests/test_tdf.py writes it)
goes through both packages' ``TdfReader``: MS2 assembly, MS1
fastcentroid, type-2 zstd frames, the codec order and dispatch through
``read_spectra``. Then ``synth_tdf`` writes a few hundred synthetic
spectra as a ddaPASEF .d (each precursor's peaks split over scans and
frames, MS1 frames between, m/z quantised to the TOF calibration) and
both Runners search it: ``results.sage.tsv`` and, with ``quant.lfq``,
``lfq.tsv`` must be byte-equal, with non-zero mobility columns.
Tolerance: exact everywhere (equal arrays, bytes and dataclass fields).
"""

import dataclasses
import json
import os
import sqlite3
import struct
import sys

import jax  # noqa: F401  (conftest keeps JAX on the CPU)
import numpy as np
import pytest

import sage_tpu.io.cloudpath as jcloud
import sage_tpu.io.tdf as jtdf
import sage_tpu_torch.io.cloudpath as tcloud
import sage_tpu_torch.io.tdf as ttdf
from test_torch_runner import _run

MZ_LO, MZ_HI, N_SAMPLES = 100.0, 1700.0, 400000
IM_LO, IM_HI = 0.6, 1.6

SCHEMA = """
CREATE TABLE GlobalMetadata (Key TEXT, Value TEXT);
CREATE TABLE Frames (Id INTEGER, Time REAL, MsMsType INTEGER,
                     TimsId INTEGER, NumScans INTEGER);
CREATE TABLE PasefFrameMsMsInfo (Frame INTEGER, ScanNumBegin INTEGER,
    ScanNumEnd INTEGER, IsolationMz REAL, IsolationWidth REAL,
    CollisionEnergy REAL, Precursor INTEGER);
CREATE TABLE Precursors (Id INTEGER, LargestPeakMz REAL,
    AverageMz REAL, MonoisotopicMz REAL, Charge INTEGER,
    ScanNumber REAL, Intensity REAL, Parent INTEGER);
"""


def _meta(compression):
    return {
        "TimsCompressionType": str(compression),
        "MzAcqRangeLower": str(MZ_LO),
        "MzAcqRangeUpper": str(MZ_HI),
        "DigitizerNumSamples": str(N_SAMPLES),
        "OneOverK0AcqRangeLower": str(IM_LO),
        "OneOverK0AcqRangeUpper": str(IM_HI),
    }


def _encode_frame(scans):
    """scans: list of [(tof, intensity), ...] per scan id."""
    u32 = []
    for peaks in scans:
        u32.append(2 * len(peaks))
    for peaks in scans:
        prev = 0
        for tof, inten in peaks:
            u32.append(tof - prev)
            u32.append(inten)
            prev = tof
    payload = np.asarray(u32, dtype=np.uint32).tobytes()
    return struct.pack("<II", len(payload) + 8, len(scans)) + payload


@pytest.fixture(scope="module")
def d_dir(tmp_path_factory):
    """tests/test_tdf.py's fixture: an MS1 frame and a PASEF MS2 frame of
    three scans; here with a second precursor on the MS2 frame whose
    MonoisotopicMz and Charge are NULL (the LargestPeakMz fallback)."""
    d = tmp_path_factory.mktemp("run") / "sample.d"
    os.makedirs(d)
    ms1 = _encode_frame(
        [[(1000, 100), (5000, 50)], [(1002, 200)], [(30000, 10)]]
    )
    ms2 = _encode_frame(
        [[(2000, 60), (2500, 40)], [(2000, 15)], [(7000, 5), (7100, 9)]]
    )
    offsets = {}
    with open(d / "analysis.tdf_bin", "wb") as f:
        offsets[1] = f.tell()
        f.write(ms1)
        offsets[2] = f.tell()
        f.write(ms2)
    con = sqlite3.connect(d / "analysis.tdf")
    con.executescript(SCHEMA)
    con.executemany("INSERT INTO GlobalMetadata VALUES (?, ?)",
                    _meta(0).items())
    con.executemany(
        "INSERT INTO Frames VALUES (?, ?, ?, ?, ?)",
        [(1, 12.0, 0, offsets[1], 3), (2, 12.5, 8, offsets[2], 3)],
    )
    con.executemany(
        "INSERT INTO PasefFrameMsMsInfo VALUES (?, ?, ?, ?, ?, ?, ?)",
        [(2, 0, 2, 460.5, 2.0, 30.0, 1), (2, 2, 3, 612.0, 3.0, 30.0, 2)],
    )
    con.executemany(
        "INSERT INTO Precursors VALUES (?, ?, ?, ?, ?, ?, ?, ?)",
        [(1, 460.52, 460.5, 460.48, 2, 1.0, 12345.0, 1),
         (2, 612.3, 612.2, None, None, 2.0, None, 1)],
    )
    con.commit()
    con.close()
    return str(d)


def _canon(x):
    """A comparable form of parser output: arrays as (dtype, shape,
    bytes), dataclasses as their fields."""
    if dataclasses.is_dataclass(x):
        return (type(x).__name__, _canon(dataclasses.asdict(x)))
    if isinstance(x, np.ndarray):
        return (x.dtype.str, x.shape, x.tobytes())
    if isinstance(x, dict):
        return tuple((k, _canon(v)) for k, v in sorted(x.items()))
    if isinstance(x, (list, tuple)):
        return tuple(_canon(v) for v in x)
    return (type(x).__name__, x)


def _both(path, **kw):
    """Both packages' TdfReader on ``path``; asserts equal output and
    returns the port's."""
    j = jtdf.TdfReader().parse(path, **kw)
    t = ttdf.TdfReader().parse(path, **kw)
    assert len(t) == len(j)
    for a, b in zip(j, t):
        assert _canon(a) == _canon(b), (a.id, b.id)
    return t


def test_ms2_assembly(d_dir):
    """PASEF MS2: scans 0..2 of frame 2 merge by TOF index; precursor m/z,
    charge, isolation window, RT and mobility as tests/test_tdf.py has
    them; the second precursor falls back to LargestPeakMz."""
    spectra = _both(d_dir, file_id=3)
    assert [s.ms_level for s in spectra] == [2, 2]
    s = spectra[0]
    assert s.file_id == 3 and s.id == "precursor=1" and s.centroid
    conv = ttdf.TofMzConverter(MZ_LO, MZ_HI, N_SAMPLES)
    np.testing.assert_array_equal(s.mz, conv.to_mz(np.array([2000, 2500])))
    np.testing.assert_array_equal(s.intensity, [75.0, 40.0])
    p = s.precursors[0]
    assert p.mz == 460.48 and p.charge == 2 and p.intensity == 12345.0
    assert (p.isolation_window.kind, p.isolation_window.lo,
            p.isolation_window.hi) == ("da", -1.0, 1.0)
    assert p.spectrum_ref == "frame=1"
    assert s.scan_start_time == 12.5 / 60.0
    im = ttdf.ScanImConverter(IM_LO, IM_HI, 3).to_im(np.array([1.0]))[0]
    assert p.inverse_ion_mobility == float(im)
    q = spectra[1].precursors[0]
    assert q.mz == 612.3 and q.charge is None and q.intensity is None
    np.testing.assert_array_equal(spectra[1].intensity, [5.0, 9.0])


def test_ms1_fastcentroid(d_dir):
    """MS1 frames centroided when asked for: tof 1000 (scan 0) and 1002
    (scan 1) lie within 5 ppm but more than 3% apart in mobility, so
    four peaks stay."""
    spectra = _both(d_dir, requires_ms1=True)
    ms1 = [s for s in spectra if s.ms_level == 1]
    assert len(ms1) == 1 and ms1[0].id == "frame=1"
    assert len(ms1[0].mz) == len(ms1[0].mobility) == 4


def test_ms1_skipped_without_flag(d_dir):
    assert all(s.ms_level == 2 for s in _both(d_dir))


def test_fast_centroid_merges_and_caps():
    """The greedy loop's merge (the most intense seed absorbs peaks within
    5 ppm and 3% mobility) and its 10,000-peak cap, in both packages."""
    mz = np.array([500.0, 500.001, 500.0005, 600.0], np.float32)
    inten = np.array([10.0, 100.0, 5.0, 1.0], np.float32)
    im = np.ones(4, np.float32)
    out = ttdf.fast_centroid(mz, inten, im, mz_ppm=5.0, ims_pct=3.0)
    assert _canon(out) == _canon(jtdf.fast_centroid(mz, inten, im))
    cmz, cint, cim = out
    assert len(cmz) == 2
    assert cint[int(np.argmin(np.abs(cmz - 500.001)))] == 115.0

    rng = np.random.default_rng(7)
    n = 12_000
    mz = (200.0 + np.arange(n) * 0.05).astype(np.float32)
    inten = rng.uniform(1.0, 1e6, n).astype(np.float32)
    im = rng.uniform(0.7, 1.4, n).astype(np.float32)
    out = ttdf.fast_centroid(mz, inten, im)
    assert _canon(out) == _canon(jtdf.fast_centroid(mz, inten, im))
    assert len(out[0]) == ttdf.MAX_MS1_PEAKS == 10_000
    # the cap keeps the most intense seeds
    kept = np.sort(out[1])[::-1]
    np.testing.assert_array_equal(kept, np.sort(inten)[::-1][:10_000])


def test_format_dispatch_tdf(d_dir):
    """Format detection, the .d filename rule and read_spectra's tdf
    branch (with and without MS1) equal sage_tpu's."""
    assert tcloud.file_format(d_dir) == "tdf"
    assert tcloud.within_file_parallel(d_dir)
    assert not tcloud.within_file_parallel("x.mzML")
    assert tcloud.filename(d_dir + "/analysis.tdf") == "sample.d"
    for ms1 in (False, True):
        got = tcloud.read_spectra(d_dir, file_id=1, requires_ms1=ms1,
                                  bruker_config={"mz_ppm": 5.0})
        want = jcloud.read_spectra(d_dir, file_id=1, requires_ms1=ms1,
                                   bruker_config={"mz_ppm": 5.0})
        assert _canon(got) == _canon(want)
        assert len(got) == 2 + ms1


def test_bruker_files_must_be_local():
    for mod in (tcloud, jcloud):
        with pytest.raises(RuntimeError, match="must be local"):
            mod.read_spectra("s3://bucket/run.d")


def _type2_dir(tmp_path, compress):
    """A one-frame .d of TimsCompressionType 2: the u32 stream
    byte-plane shuffled, then compressed by ``compress``."""
    d = tmp_path / "z.d"
    os.makedirs(d)
    u32 = np.asarray([2, 4, 1000, 100, 2000, 60, 500, 40], np.uint32)
    shuffled = np.frombuffer(u32.tobytes(), np.uint8).reshape(-1, 4).T
    payload = compress(shuffled.tobytes())
    with open(d / "analysis.tdf_bin", "wb") as f:
        f.write(struct.pack("<II", len(payload) + 8, 2) + payload)
    con = sqlite3.connect(d / "analysis.tdf")
    con.executescript(SCHEMA)
    con.executemany("INSERT INTO GlobalMetadata VALUES (?, ?)",
                    _meta(2).items())
    con.execute("INSERT INTO Frames VALUES (1, 5.0, 8, 0, 2)")
    con.execute(
        "INSERT INTO PasefFrameMsMsInfo VALUES (1, 0, 2, 450.0, 2.0, 30.0, 1)"
    )
    con.execute(
        "INSERT INTO Precursors VALUES (1, 450.1, 450.0, 449.9, 2, 0.0, 1.0, 1)"
    )
    con.commit()
    con.close()
    return str(d)


def _zstandard_compress(data):
    import zstandard

    return zstandard.ZstdCompressor(level=3).compress(data)


def test_compression_type2_zstd(tmp_path):
    """Type-2 frames (zstd, byte-plane shuffled) decode to the same
    spectrum in both packages: scan 0 holds tof 1000, scan 1 the
    within-scan cumulative tofs 2000 and 2500."""
    pytest.importorskip("zstandard")
    spectra = _both(_type2_dir(tmp_path, _zstandard_compress))
    assert len(spectra) == 1
    conv = ttdf.TofMzConverter(MZ_LO, MZ_HI, N_SAMPLES)
    np.testing.assert_array_equal(spectra[0].mz,
                                  conv.to_mz(np.array([1000, 2000, 2500])))
    np.testing.assert_array_equal(spectra[0].intensity, [100.0, 60.0, 40.0])


@pytest.mark.parametrize("codec", ["zstandard", "pyarrow", "none"])
def test_zstd_codec_order(tmp_path, monkeypatch, codec):
    """The codecs in sage_tpu's order: compression.zstd, zstandard, then
    pyarrow's (which needs the frame's content size); with none
    importable both packages raise the same error."""
    pytest.importorskip("zstandard")
    data = _zstandard_compress(bytes(range(256)) * 8)
    blocked = ["compression"] + {"zstandard": [],
                                 "pyarrow": ["zstandard"],
                                 "none": ["zstandard", "pyarrow"]}[codec]
    if codec == "pyarrow":
        pytest.importorskip("pyarrow")
    for name in blocked:
        monkeypatch.setitem(sys.modules, name, None)
    if codec == "none":
        for mod in (ttdf, jtdf):
            with pytest.raises(RuntimeError, match="no zstd codec"):
                mod._zstd_decompress(data)
        return
    assert ttdf._zstd_decompress(data) == jtdf._zstd_decompress(data) == \
        bytes(range(256)) * 8
    assert ttdf._zstd_frame_content_size(data) == 2048


# ---------------------------------------------------------------------------
# A synthetic ddaPASEF .d through both Runners
# ---------------------------------------------------------------------------

CONFIG = {
    "database": {"static_mods": {"C": 57.0215},
                 "variable_mods": {"M": [15.9949]},
                 "generate_decoys": True},
    "precursor_tol": {"ppm": [-20, 20]},
    "fragment_tol": {"ppm": [-10, 10]},
    "deisotope": False,
    "write_pin": True,
}


@pytest.fixture(scope="module")
def synth_d(tmp_path_factory):
    """400 spectra of ``synth_spectra`` drawn from the targets of a
    60-protein ``synth_fasta`` (a database built without decoys), written
    by ``synth_tdf``; returns (fasta path, .d path, spectra)."""
    from sage_tpu_torch.bench_baseline import (
        synth_fasta, synth_spectra, synth_tdf,
    )
    from sage_tpu_torch.chem.fasta import Fasta
    from sage_tpu_torch.index.builder import DatabaseParams

    d = tmp_path_factory.mktemp("synth_d")
    text = synth_fasta(60, seed=21)
    (d / "db.fasta").write_text(text)
    dbp = DatabaseParams.from_config(
        dict(CONFIG["database"], generate_decoys=False))
    targets = dbp.build(Fasta.parse(text, dbp.decoy_tag, False))
    spectra = synth_spectra(targets, 400, seed=23)
    synth_tdf(str(d / "run.d"), spectra, seed=25)
    return str(d / "db.fasta"), str(d / "run.d"), spectra


def test_synth_tdf_readers_equal(synth_d):
    """Both readers give equal spectra on the synthetic .d, with and
    without MS1; summing over frames and scans gives back each
    spectrum's peaks in the acquisition range, on the TOF grid."""
    from sage_tpu_torch.bench_baseline import TDF_MZ
    from sage_tpu_torch.chem.mass import PROTON

    _, path, spectra = synth_d
    ms2 = _both(path)
    full = _both(path, requires_ms1=True)
    assert [s for s in full if s.ms_level == 2] and len(full) == 440
    assert _canon(ms2) == _canon([s for s in full if s.ms_level == 2])
    conv = ttdf.TofMzConverter(*TDF_MZ, N_SAMPLES)
    lo, hi = np.sqrt(TDF_MZ[0]), np.sqrt(TDF_MZ[1])
    for raw, s in zip(ms2[::37], spectra[::37]):
        mz = s.masses.astype(np.float64) + PROTON
        keep = (mz > TDF_MZ[0]) & (mz < TDF_MZ[1])
        tof = np.rint((np.sqrt(mz[keep]) - lo) / (hi - lo)
                      * (N_SAMPLES - 1)).astype(np.int64)
        u, inv = np.unique(tof, return_inverse=True)
        want = np.bincount(inv, np.rint(s.intensities[keep]))
        np.testing.assert_array_equal(raw.mz, conv.to_mz(u))
        np.testing.assert_array_equal(raw.intensity, want.astype(np.float32))
        assert raw.precursors[0].mz == s.precursors[0].mz


@pytest.fixture(scope="module")
def tdf_runs(synth_d, tmp_path_factory):
    """Both Runners on the synthetic .d, without and with quant.lfq:
    {case: (jax outdir, jax result, port outdir, port result)}."""
    fasta, path, _ = synth_d
    out = {}
    for case, extra in (("plain", {}), ("lfq", {"quant": {"lfq": True}})):
        cfg = json.loads(json.dumps(CONFIG))
        cfg["database"]["fasta"] = fasta
        cfg["mzml_paths"] = [path]
        cfg.update(extra)
        jd = tmp_path_factory.mktemp(f"jax_tdf_{case}")
        td = tmp_path_factory.mktemp(f"port_tdf_{case}")
        out[case] = (jd, _run("jax", cfg, jd), td, _run("port", cfg, td))
    return out


def _tsv_column(path, name):
    with open(path) as f:
        head = f.readline().rstrip("\n").split("\t")
        i = head.index(name)
        return np.array([float(ln.split("\t")[i]) for ln in f])


def test_tdf_runners_byte_equal(tdf_runs):
    """results.sage.tsv and results.sage.pin byte-equal, equal FDR
    counts; the PSMs carry the .d's ion mobility and the mobility
    model's prediction (both non-zero)."""
    jd, jres, td, tres = tdf_runs["plain"]
    for name in ("results.sage.tsv", "results.sage.pin"):
        with open(jd / name, "rb") as a, open(td / name, "rb") as b:
            assert a.read() == b.read(), name
    assert jres == tres and tres["q_spectrum"] > 100
    tsv = td / "results.sage.tsv"
    for col in ("ion_mobility", "predicted_mobility", "delta_mobility"):
        v = _tsv_column(tsv, col)
        assert (v > 0).mean() > 0.9, col
    assert _tsv_column(tsv, "ion_mobility").max() <= IM_HI


def test_tdf_runners_lfq_byte_equal(tdf_runs):
    """With quant.lfq the MS1 frames are centroided and quantified:
    lfq.tsv and results.sage.tsv byte-equal, equal quantified areas."""
    jd, jres, td, tres = tdf_runs["lfq"]
    lj, lt = jres.pop("lfq"), tres.pop("lfq")
    assert jres == tres
    assert {k: (vars(p), a) for k, (p, a) in lj.items()} == {
        k: (vars(p), a) for k, (p, a) in lt.items()}
    for name in ("results.sage.tsv", "lfq.tsv"):
        with open(jd / name, "rb") as a, open(td / name, "rb") as b:
            assert a.read() == b.read(), name
    with open(td / "lfq.tsv") as f:
        assert len(f.read().splitlines()) > 50
