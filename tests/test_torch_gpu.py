"""The port on a CUDA device: the stage-1, row-sort, cluster-sort and
rescore kernels against their plain versions on the card (at crafted
edges, peaks on their IEEE bounds, dead items and 12,000-peak spectra
among them), and the whole narrow, banded, chimeric and open paths
(fused and two-dispatch), the multi-device grid (four shards on the one
card) and the Runner on the card against the CPU.
Every test here needs a card; where there is none they skip.

Run on a machine with a card (the variable keeps conftest.py from
importing jax, which that machine may not have):
    SAGE_TPU_TEST_PLATFORM=cuda python -m pytest tests/test_torch_gpu.py -q -m gpu
"""

import ctypes
import dataclasses
import json

import numpy as np
import pytest
import torch

from sage_tpu_torch.bench_baseline import synth_fasta, synth_spectra
from sage_tpu_torch.chem.fasta import Fasta
from sage_tpu_torch.chem.mass import Tolerance
from sage_tpu_torch.index.builder import DatabaseParams
from sage_tpu_torch.ops import batch_prep as tprep
from sage_tpu_torch.ops import narrow_banded as tbanded
from sage_tpu_torch.ops import open_search as topen
from sage_tpu_torch.ops import pallas_sort, pallas_stage1
from sage_tpu_torch.ops import rescore as trescore
from sage_tpu_torch.ops.search import Scorer, SearchParams
from sage_tpu_torch.utils import trace

import _peak_cases as pc
from _rescore_cases import (CARD_SHAPES, RANDOM, indexed_case, kernel_cases,
                            large_peak_arrays, shape_case)

pytestmark = pytest.mark.gpu


@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.fixture(scope="module")
def small(cuda):
    params = DatabaseParams()
    db = params.build(Fasta.parse(synth_fasta(300), params.decoy_tag, True))
    spectra = synth_spectra(db, 256, seed=5)
    for i, s in enumerate(spectra):
        s.precursors[0].charge = 2 + i % 2
    return db, spectra


def _params(frag):
    return SearchParams(
        precursor_tol=Tolerance("da", -5.0, 5.0),
        fragment_tol=Tolerance(*frag), min_isotope_err=-1,
        max_isotope_err=1, report_psms=2, min_matched_peaks=2,
    )


@pytest.mark.parametrize("W", [8, 40, 64, 256])
@pytest.mark.parametrize("Z", [1, 3])
@pytest.mark.parametrize("frag", [("ppm", -10.0, 10.0), ("da", -0.02, 0.02)])
def test_stage1_kernel_matches_plain(cuda, small, W, Z, frag):
    db, spectra = small
    s = Scorer(db, _params(frag), device=cuda)
    masses, intens, Pk = s._pad_peaks(spectra[:32])
    peaks = torch.from_numpy(masses).to(cuda)
    rng = np.random.default_rng(W * 7 + Z)
    R = 200
    P_pad = s.tables.P_pad
    p0 = rng.integers(0, len(db) - W, R)
    i0 = p0 + rng.integers(0, W // 4 + 1, R)
    ints = np.stack([
        rng.integers(0, 34, R), p0, i0, i0 + rng.integers(0, W + 1, R),
        rng.choice([2, 3, 4], R),
    ]).astype(np.int32)
    ints[1] = np.minimum(ints[1], P_pad - W)
    ints_d = torch.from_numpy(ints).to(cuda)
    for Lc in (12, s.tables.L):
        kw = dict(W=W, Lc=Lc, Z=Z, tol=frag)
        before = pallas_stage1.launches
        got = pallas_stage1.stage1_counts(s.tables.lad_index, peaks, ints_d,
                                          **kw)
        assert pallas_stage1.launches == before + 1
        want = pallas_stage1.stage1_counts_plain(s.tables.lad_index, peaks,
                                                 ints_d, **kw)
        torch.cuda.synchronize()
        assert torch.equal(got, want)
        assert (want[:, :W] > 0).any()


@pytest.mark.parametrize("frag", [("ppm", -10.0, 10.0), ("pct", -0.002, 0.002),
                                  ("da", -0.02, 0.02)])
def test_stage1_kernel_ragged_tiles(cuda, small, frag):
    """The kernel's tiling at its ragged edges: S * Lc off multiples of
    32, Pk off multiples of 4, W and the live fragments off the
    256 x 8 tile, Z = 3, empty windows and rows with no live plane."""
    db, spectra = small
    s = Scorer(db, _params(frag), device=cuda)
    masses, _intens, Pk = s._pad_peaks(spectra[:40])
    rng = np.random.default_rng(3)
    P_pad, L = s.tables.P_pad, s.tables.L
    for W, Lc, pk in ((33, 7, 37), (257, 11, Pk - 1), (100, L, 5),
                      (1, 1, 1), (300, 13, Pk)):
        peaks = torch.from_numpy(np.ascontiguousarray(masses[:, :pk])).to(cuda)
        R = 97
        p0 = rng.integers(0, len(db) - W, R)
        i0 = p0 + rng.integers(-2, W // 4 + 2, R)
        i1 = i0 + rng.integers(-1, W + 2, R)  # some windows empty
        ints = np.stack([rng.integers(0, 40, R), np.minimum(p0, P_pad - W),
                         i0, i1, rng.choice([1, 2, 3, 4], R)]).astype(np.int32)
        ints_d = torch.from_numpy(ints).to(cuda)
        kw = dict(W=W, Lc=min(Lc, L), Z=3, tol=frag)
        got = pallas_stage1.stage1_counts(s.tables.lad_index, peaks, ints_d,
                                          **kw)
        want = pallas_stage1.stage1_counts_plain(s.tables.lad_index, peaks,
                                                 ints_d, **kw)
        torch.cuda.synchronize()
        assert torch.equal(got, want), (W, Lc, pk, frag)


def test_narrow_path_card_matches_cpu(cuda, small):
    db, spectra = small
    params = _params(("ppm", -10.0, 10.0))
    before = pallas_stage1.launches
    before_r = trescore.launches
    t_gpu = Scorer(db, params, device=cuda).score_table(spectra)
    assert pallas_stage1.launches > before
    assert trescore.launches > before_r
    t_cpu = Scorer(db, params, device="cpu").score_table(spectra)
    assert len(t_gpu) == len(t_cpu) > 0
    for k in t_cpu.columns:
        np.testing.assert_array_equal(t_gpu.columns[k], t_cpu.columns[k],
                                      err_msg=f"column {k}")


# the CPU tests' shapes and the card's own (one item a row, several warps
# of items a row, the widest ladder)
_RESCORE_RANDOM = RANDOM + list(CARD_SHAPES.values())


def _rescore_on_card(case, cuda):
    args = [torch.from_numpy(case[k]).to(cuda)
            for k in ("f", "pkm", "pki", "maxz")]
    kw = dict(series=case["series"], frag_tol=case["frag_tol"], Z=case["Z"])
    before = trescore.launches
    got = trescore.rescore_candidate(*args, **kw)
    launched = trescore.launches - before
    want = trescore.rescore_candidate_plain(*args, **kw)
    torch.cuda.synchronize()
    assert launched == (case["maxz"].size > 0)
    for name, g, w in zip(("mb", "my", "summed_b", "summed_y", "ppm_sum",
                           "longest_b", "longest_y"), got, want):
        assert g.device == w.device and g.dtype == w.dtype, name
        if g.dtype == torch.float32:
            g, w = g.view(torch.int32), w.view(torch.int32)
        assert torch.equal(g, w), name
    return got


@pytest.mark.parametrize("name", sorted(kernel_cases()))
def test_rescore_kernel_crafted(cuda, name):
    """The rescore kernel against its plain version on the card at the
    edge cases whose rows ascend in mass (its precondition), bit for
    bit."""
    _rescore_on_card(kernel_cases()[name], cuda)


@pytest.mark.parametrize(
    "series,L,Pk,Z,tol,n,k", _RESCORE_RANDOM,
    ids=[f"{''.join(s)}-L{L}-Pk{P}-Z{Z}-{t}-n{n}-k{k}"
         for s, L, P, Z, t, n, k in _RESCORE_RANDOM])
def test_rescore_kernel_random(cuda, series, L, Pk, Z, tol, n, k):
    case = shape_case((series, L, Pk, Z, tol, n, k), seed_extra=k)
    got = _rescore_on_card(case, cuda)
    assert int(got[0].sum() + got[1].sum()) > 0


@pytest.mark.parametrize("B,F,block", [
    (3, 1, None), (7, 100, None), (64, 4096, None), (5, 32768, None),
    (4, 70000, None), (6, 5000, 1024), (3, 40000, 5000),
    # every cluster size the wrapper picks past 2^15 keys (3-8 slices of
    # up to 2^14 keys), and 2-4 slices with the slice size forced
    (3, 32769, None), (3, 53000, None), (3, 65536, None), (2, 90000, None),
    (2, 110000, None), (2, 131072, None), (4, 3000, 1500), (4, 3000, 1000),
    (4, 3001, 751),
])
def test_sort_kernels_match_plain(cuda, B, F, block):
    """One-pass rows up to 2^15 keys (the row-sort kernel) and longer
    rows, or rows past a forced slice size (the cluster kernel, one
    launch): bit-equal to the plain version and to torch.sort, with
    sentinel keys and duplicates."""
    rng = np.random.default_rng(B * 31 + F)
    x = rng.integers(-50, 50, size=(B, F)).astype(np.int32)
    x[:, F // 2:F // 2 + 7] = 2**31 - 1
    xd = torch.from_numpy(x).to(cuda)
    before = dict(pallas_sort.launches)
    got = pallas_sort.bitonic_sort_rows(xd, block=block)
    torch.cuda.synchronize()
    long_row = F > min(block or pallas_sort._BLOCK_MAX, pallas_sort._BLOCK_MAX)
    grew = {k: pallas_sort.launches[k] - before[k] for k in before}
    assert grew == {"row_sort": int(not long_row),
                    "cluster_sort": int(long_row)}
    want = pallas_sort.bitonic_sort_rows(torch.from_numpy(x), block=block)
    assert torch.equal(got.cpu(), want)
    assert torch.equal(got, torch.sort(xd, dim=1).values)


@pytest.mark.parametrize("F", [1025, 3000, 8192, 8193, 20000, 32768])
def test_cluster_sort_lowered_one_pass_limit(cuda, monkeypatch, F):
    """With the one-pass limit lowered to 1024 (chip_smoke.py phase 7),
    rows of the open search's widths go to the cluster kernel in 1-2
    slices of up to 2^14 keys: bit-equal to the plain version and
    torch.sort."""
    monkeypatch.setattr(pallas_sort, "_BLOCK_MAX", 1024)
    rng = np.random.default_rng(F)
    x = _radix_keys("open", 8, F, rng)
    xd = torch.from_numpy(x).to(cuda)
    before = pallas_sort.launches["cluster_sort"]
    got = pallas_sort.bitonic_sort_rows(xd)
    torch.cuda.synchronize()
    assert pallas_sort.launches["cluster_sort"] == before + 1
    assert pallas_sort.cluster_shape(F)[0] == -(-F // 2**14)
    assert torch.equal(got.cpu(), pallas_sort.cluster_sort_plain(
        torch.from_numpy(x)))
    assert torch.equal(got, torch.sort(xd, dim=1).values)


def test_cluster_sort_refuses_more_than_8_slices(cuda):
    """A slice size that needs more than 8 CTAs a row is refused on the
    card (the CPU plain version takes any slice count)."""
    x = torch.zeros((2, 4096), dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError, match="at most 8 CTAs"):
        pallas_sort.cluster_sort(x, block=500)


def _radix_keys(kind, B, F, rng):
    """The key kinds of tests/test_torch_sort.py's radix cases."""
    wide = rng.integers(-(2**31), 2**31, size=(B, F), dtype=np.int64)
    if kind == "int32_range":
        x = wide.astype(np.int32)
        marks = np.array([-(2**31), -1, 0, 2**31 - 1], np.int32)
        for r in range(B):
            at = rng.choice(F, size=min(F, 4), replace=False)
            x[r, at] = marks[: at.size]
        return x
    if kind == "equal":
        return np.full((B, F), rng.integers(-(2**31), 2**31), np.int32)
    if kind == "sorted":
        return np.sort(wide.astype(np.int32), axis=1)
    if kind == "reversed":
        return np.sort(wide.astype(np.int32), axis=1)[:, ::-1].copy()
    if kind == "ties":
        # INT32_MAX ties 255 and the open key 2^25 - 1 on its low digits
        x = np.ascontiguousarray(np.tile(np.array([2**31 - 1, 255, 0],
                                                  np.int32),
                                         (B, F // 3 + 1))[:, :F])
        x[1::2, :F // 2] = 2**31 - 1
        x[1::2, F // 2:] = 2**25 - rng.integers(1, 4,
                                                size=(len(x[1::2]), F - F // 2))
        return x
    pep = rng.integers(40_000, 43_000, size=(B, F))
    x = (((2**25 - pep) << 5) | rng.integers(1, 4, size=(B, F))).astype(
        np.int32)
    x[rng.random((B, F)) < 0.8] = 2**31 - 1
    for r in range(B):
        x[r, int(rng.integers(0, F + 1)):] = 2**31 - 1
    return x


@pytest.mark.parametrize("kind", ["int32_range", "equal", "sorted",
                                  "reversed", "open", "ties"])
def test_row_sort_kernel_key_kinds(cuda, kind):
    """The radix kernels on every key kind, at widths around the row-sort
    kernel's digit, warp and thread-count edges and its keys-per-thread
    steps, up to 2^15 keys in one pass, and past it (the cluster kernel,
    3 and 8 slices): bit-equal to the plain versions and to torch.sort."""
    rng = np.random.default_rng(len(kind))
    for B, F in ((5, 1), (4, 255), (4, 257), (3, 1023), (3, 1025),
                 (3, 2049), (3, 8193), (2, 20480), (2, 32767), (2, 32768),
                 (2, 40000), (2, 131072)):
        x = torch.from_numpy(_radix_keys(kind, B, F, rng)).to(cuda)
        before = dict(pallas_sort.launches)
        got = pallas_sort.bitonic_sort_rows(x)
        torch.cuda.synchronize()
        long_row = F > pallas_sort._BLOCK_MAX
        assert (pallas_sort.launches["cluster_sort"]
                - before["cluster_sort"]) == int(long_row)
        assert torch.equal(got, torch.sort(x, dim=1).values), (kind, F)
        plain = (pallas_sort.cluster_sort_plain(x.cpu()) if long_row
                 else pallas_sort.sort_rows_plain(x.cpu()))
        assert torch.equal(got.cpu(), plain), (kind, F)


def test_open_path_card_matches_cpu(cuda, small, monkeypatch):
    """The open search (-500/+100 Da) on the card, sort kernel included,
    against the CPU: every FeatureTable column equal."""
    db, spectra = small
    monkeypatch.setenv("SAGE_TPU_OPEN_THRESHOLD", "1")
    params = SearchParams(
        precursor_tol=Tolerance("da", -500.0, 100.0),
        fragment_tol=Tolerance("ppm", -10.0, 10.0), report_psms=2,
    )
    before = pallas_sort.launches["row_sort"]
    gpu = Scorer(db, params, device=cuda)
    t_gpu = list(gpu.score_stream([spectra[:96], spectra[96:192]]))
    assert gpu.last_plan.get("open")
    assert pallas_sort.launches["row_sort"] > before
    cpu = Scorer(db, params, device="cpu")
    t_cpu = list(cpu.score_stream([spectra[:96], spectra[96:192]]))
    for a, b in zip(t_gpu, t_cpu):
        assert len(a) == len(b) > 0
        for k in b.columns:
            np.testing.assert_array_equal(a.columns[k], b.columns[k],
                                          err_msg=f"column {k}")


@pytest.mark.parametrize("regime", ["narrow", "open"])
def test_two_dispatch_card_matches_cpu(cuda, small, monkeypatch, regime):
    """The two-dispatch path (SAGE_TPU_FUSED=0) on the card, its stage-1
    or row-sort kernel launched, against the CPU: every FeatureTable
    column equal."""
    db, spectra = small
    monkeypatch.setenv("SAGE_TPU_FUSED", "0")
    if regime == "open":
        monkeypatch.setenv("SAGE_TPU_OPEN_THRESHOLD", "1")
        params = SearchParams(
            precursor_tol=Tolerance("da", -500.0, 100.0),
            fragment_tol=Tolerance("ppm", -10.0, 10.0), report_psms=2,
        )
        count = ("row_sort", lambda: pallas_sort.launches["row_sort"])
    else:
        params = _params(("ppm", -10.0, 10.0))
        count = ("stage1", lambda: pallas_stage1.launches)
    before = count[1]()
    before_r = trescore.launches
    t_gpu = list(Scorer(db, params, device=cuda).score_stream(
        [spectra[:96], spectra[96:192]]))
    assert count[1]() > before, count[0]
    assert trescore.launches > before_r
    t_cpu = list(Scorer(db, params, device="cpu").score_stream(
        [spectra[:96], spectra[96:192]]))
    for a, b in zip(t_gpu, t_cpu):
        assert len(a) == len(b) > 0
        for k in b.columns:
            np.testing.assert_array_equal(a.columns[k], b.columns[k],
                                          err_msg=f"column {k}")


def _assert_same(a_tables, b_tables):
    for a, b in zip(a_tables, b_tables):
        assert len(a) == len(b) > 0
        for k in b.columns:
            np.testing.assert_array_equal(a.columns[k], b.columns[k],
                                          err_msg=f"column {k}")


@pytest.mark.parametrize("F", [None, 40000])
def test_banded_card_matches_cpu(cuda, small, monkeypatch, F):
    """The banded narrow stage 1 (forced, bands of 64 peptides) on the
    card: the row-sort kernel launched or, with F = 40,000 entries a
    spectrum (rows past 2^15 keys), the cluster kernel; every FeatureTable
    column equal to the CPU's. A first batch learns F."""
    db, spectra = small
    monkeypatch.setenv("SAGE_TPU_NARROW_BANDED", "1")
    monkeypatch.setenv("SAGE_TPU_NARROW_BAND_W", "64")
    params = _params(("ppm", -10.0, 10.0))
    tables = {}
    for dev in (cuda, torch.device("cpu")):
        s = Scorer(db, params, device=dev)
        if F:
            s._narrow_banded_maybe(4096)._F = F
        s.score_table(spectra[192:])
        s._psm_counter = 1
        before = dict(pallas_sort.launches)
        tables[dev.type] = list(s.score_stream([spectra[:96],
                                                spectra[96:192]]))
        assert s.last_plan.get("banded") and s.last_plan["F"] >= (F or 0)
        grew = {k: pallas_sort.launches[k] - before[k] for k in before}
        if dev.type == "cuda":
            assert grew["cluster_sort" if F else "row_sort"] > 0
        else:
            assert grew == {"row_sort": 0, "cluster_sort": 0}
    _assert_same(tables["cuda"], tables["cpu"])


def test_chimera_card_matches_cpu(cuda, small):
    """Chimeric search (report_psms 2) on the card, the stage-1 kernel
    launched and the peaks uploaded again each round: every FeatureTable
    column equal to the CPU's."""
    db, spectra = small
    params = dataclasses.replace(_params(("ppm", -10.0, 10.0)), chimera=True)
    before = pallas_stage1.launches
    t_gpu = Scorer(db, params, device=cuda).score_table(spectra[:64])
    assert pallas_stage1.launches > before
    t_cpu = Scorer(db, params, device="cpu").score_table(spectra[:64])
    assert (t_cpu.columns["rank"] == 2).any()
    _assert_same([t_gpu], [t_cpu])


def _write_mgf(path, spectra):
    """The spectra as an MGF file: singly charged peaks (mass + proton)."""
    from sage_tpu_torch.chem.mass import PROTON

    lines = []
    for s in spectra:
        prec = s.precursors[0]
        lines += ["BEGIN IONS", f"TITLE={s.id}", f"PEPMASS={prec.mz!r}",
                  f"CHARGE={prec.charge}+",
                  f"RTINSECONDS={60.0 * s.scan_start_time!r}"]
        lines += [f"{float(m) + float(PROTON)!r} {float(v)!r}"
                  for m, v in zip(s.masses, s.intensities)]
        lines.append("END IONS")
    path.write_text("\n".join(lines) + "\n")


def test_runner_card_matches_cpu(cuda, tmp_path):
    """The Runner on the card and on the CPU, from a FASTA and an MGF
    file to results.sage.tsv and results.sage.pin: byte-equal files, the
    stage-1 kernel launched."""
    from sage_tpu_torch.pipeline.input import build_search
    from sage_tpu_torch.pipeline.runner import Runner

    text = synth_fasta(50)
    (tmp_path / "db.fasta").write_text(text)
    params = DatabaseParams()
    db = params.build(Fasta.parse(text, params.decoy_tag, True))
    _write_mgf(tmp_path / "run.mgf", synth_spectra(db, 128, seed=9))
    cfg = {"database": {"fasta": str(tmp_path / "db.fasta")},
           "precursor_tol": {"ppm": [-20, 20]},
           "fragment_tol": {"ppm": [-10, 10]}, "deisotope": False,
           "mzml_paths": [str(tmp_path / "run.mgf")], "write_pin": True}
    outs = {}
    for dev in ("cuda", "cpu"):
        out = tmp_path / dev
        before = pallas_stage1.launches
        Runner(build_search(json.loads(json.dumps(cfg)),
                            output_directory=str(out)), device=dev).run()
        assert (pallas_stage1.launches > before) == (dev == "cuda")
        outs[dev] = [(out / n).read_bytes()
                     for n in ("results.sage.tsv", "results.sage.pin")]
    assert outs["cuda"] == outs["cpu"]
    assert outs["cpu"][0].count(b"\n") > 64


# the grid's steps: (environment, the kernel counter that must grow)
_GRID_PATHS = {
    "windowed": ({"SAGE_TPU_SHARD_WINDOWED": "1"}, "stage1"),
    "full": ({"SAGE_TPU_SHARD_WINDOWED": "0", "SAGE_TPU_SHARD_OPEN": "0"},
             "stage1"),
    "banded": ({"SAGE_TPU_SHARD_WINDOWED": "0", "SAGE_TPU_SHARD_OPEN": "1"},
               "sort"),
    "chimera": ({}, "stage1"),
}


def _launch_count(kind):
    if kind == "stage1":
        return pallas_stage1.launches
    return pallas_sort.launches["row_sort"] + pallas_sort.launches[
        "cluster_sort"]


@pytest.mark.parametrize("path", sorted(_GRID_PATHS))
def test_grid_card_matches_cpu(cuda, small, monkeypatch, path):
    """A (2, 2) grid of four shards on the one card (cuda:0 four times):
    the windowed, whole-table and banded open steps and chimeric search
    launch their kernels on the shards, and every FeatureTable column
    equals the single-device CPU Scorer's."""
    from sage_tpu_torch.parallel import sharding

    db, spectra = small
    env, kind = _GRID_PATHS[path]
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    params = _params(("ppm", -10.0, 10.0))
    if path == "chimera":
        params = dataclasses.replace(params, chimera=True)
    mesh = sharding.make_mesh(2, 2, devices=[cuda] * 4)
    sc = sharding.ShardedScorer(db, mesh, params)
    before = _launch_count(kind)
    t_gpu = sc.score_table(spectra[:96])
    torch.cuda.synchronize()
    assert _launch_count(kind) > before, kind
    if path != "chimera":
        assert sc.last_route[0] == {"windowed": "win", "full": "full",
                                    "banded": "open"}[path]
    t_cpu = Scorer(db, params, device="cpu").score_table(spectra[:96])
    _assert_same([t_gpu], [t_cpu])


def test_runner_grid_card_matches_cpu(cuda, tmp_path, monkeypatch):
    """The Runner on a (2, 2) grid on the one card against the CPU
    Runner on one device: results.sage.tsv byte-equal, the stage-1 kernel
    launched."""
    from sage_tpu_torch.parallel import sharding
    from sage_tpu_torch.pipeline.input import build_search
    from sage_tpu_torch.pipeline.runner import Runner

    text = synth_fasta(50)
    (tmp_path / "db.fasta").write_text(text)
    params = DatabaseParams()
    db = params.build(Fasta.parse(text, params.decoy_tag, True))
    _write_mgf(tmp_path / "run.mgf", synth_spectra(db, 128, seed=9))
    cfg = {"database": {"fasta": str(tmp_path / "db.fasta")},
           "precursor_tol": {"ppm": [-20, 20]},
           "fragment_tol": {"ppm": [-10, 10]}, "deisotope": False,
           "mzml_paths": [str(tmp_path / "run.mgf")]}
    monkeypatch.delenv("SAGE_TPU_MESH", raising=False)
    monkeypatch.setattr(sharding, "local_devices",
                        lambda device="cuda": [cuda] * 4)
    outs = {}
    for dev, shape in (("cuda", (2, 2)), ("cpu", (1, 1))):
        out = tmp_path / dev
        before = pallas_stage1.launches
        Runner(build_search(json.loads(json.dumps(cfg)),
                            output_directory=str(out), mesh_shape=shape),
               device=dev).run()
        assert (pallas_stage1.launches > before) == (dev == "cuda")
        outs[dev] = (out / "results.sage.tsv").read_bytes()
    assert outs["cuda"] == outs["cpu"]
    assert outs["cpu"].count(b"\n") > 64


def _kernel_vs_plain_stage1(lad, peaks, ints, **kw):
    before = pallas_stage1.launches
    got = pallas_stage1.stage1_counts(lad, peaks, ints, **kw)
    assert pallas_stage1.launches == before + 1
    want = pallas_stage1.stage1_counts_plain(lad, peaks, ints, **kw)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    return got


@pytest.mark.parametrize("tol", [("ppm", -10.0, 10.0), ("ppm", -20.0, 20.0),
                                 ("pct", -0.001, 0.002)])
@pytest.mark.parametrize("Z", [1, 3])
def test_stage1_kernel_on_ieee_bounds(cuda, tol, Z):
    """Fragments exactly on their peaks' IEEE bounds and one ulp either
    side (tests/test_torch_stage1.py's segment): the kernel equals its
    plain version, which the CPU test holds to a numpy IEEE count."""
    from test_torch_stage1 import _on_bound_segment

    lad, peaks, ints, W, Lc = _on_bound_segment(tol, Z)
    got = _kernel_vs_plain_stage1(
        torch.from_numpy(lad).to(cuda), torch.from_numpy(peaks).to(cuda),
        torch.from_numpy(ints).to(cuda), W=W, Lc=Lc, Z=Z, tol=tol)
    assert int(got[:, :W].max()) == 4


def _rescore_indexed_on_card(c, cuda):
    args = [torch.from_numpy(np.asarray(c[k])).to(cuda)
            for k in ("lad", "pep", "spec", "pkm", "pki", "maxz")]
    live = None if c["live"] is None else torch.from_numpy(c["live"]).to(cuda)
    kw = dict(series=c["series"], frag_tol=c["frag_tol"], Z=c["Z"])
    before = trescore.launches
    got = trescore.rescore_indexed(*args, live, **kw)
    assert trescore.launches == before + 1
    want = trescore.rescore_indexed_plain(*args, live, **kw)
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        if g.dtype == torch.float32:
            g, w = g.view(torch.int32), w.view(torch.int32)
        assert torch.equal(g, w)
    return got


@pytest.mark.parametrize("seed,shape", [(1, RANDOM[1]), (2, RANDOM[4]),
                                        (3, RANDOM[7]),
                                        (4, CARD_SHAPES["k1"]),
                                        (5, CARD_SHAPES["warps"]),
                                        (6, CARD_SHAPES["smem_48k"])])
def test_rescore_indexed_kernel_dead_items(cuda, seed, shape):
    """The indexed entry point on the card (a shuffled ladder table,
    shuffled peak rows, rows of dead items): all seven outputs bit-equal
    to the plain version, 0 at the dead items."""
    c = indexed_case(seed, shape)
    got = _rescore_indexed_on_card(c, cuda)
    dead = torch.from_numpy(np.arange(c["pep"].shape[1])[None, :]
                            >= c["live"][:, None]).to(cuda)
    assert bool(dead.any()) and not any(bool(o[dead].any()) for o in got)


def test_kernel_sizing_mirrors(cuda):
    """The wrappers' sizing formulas equal the kernels' own, and the
    gather's equals the model's in tests/_peak_cases.py."""
    s1 = pallas_stage1._bind()
    for W, Pk, Z in ((50, 128, 1), (50, 12000, 3), (4096, 1023, 4),
                     (16384, 2049, 2)):
        assert s1.stage1_counts_smem_bytes(W, Pk, Z) == \
            pallas_stage1.stage1_counts_smem_bytes(W, Pk, Z)
    rs = trescore._bind()
    for S, L in ((1, 7), (2, 47), (4, 64), (6, 100)):
        assert rs.rescore_smem_bytes(S, L) == trescore.rescore_smem_bytes(S, L)
    oe = topen._bind("open_entries").open_entries_smem_bytes
    oe.argtypes, oe.restype = [ctypes.c_int] * 3, ctypes.c_longlong
    for Z, Pk, u in ((1, 8, 384), (3, 128, 112), (3, 128, 1280),
                     (3, 12000, 65536), (4, 2048, 4097), (2, 4097, 7)):
        assert oe(Z, Pk, u) == pc.entries_smem_bytes(Z, Pk, u)


def test_kernels_at_12000_peaks(cuda, small):
    """Spectra of 12,000 peaks (max_peaks 12,000): the stage-1 kernel at
    Z = 3 and the rescore kernel, each against its plain version, where
    the untiled kernels needed more than a block's shared memory."""
    from sage_tpu_torch.spectrum.processor import (Precursor, RawSpectrum,
                                                   SpectrumProcessor)

    db, _ = small
    proc = SpectrumProcessor(12000, False)
    spectra = [proc.process(RawSpectrum(
        ms_level=2, id=f"scan={i}", centroid=True,
        precursors=[Precursor(mz=a["prec_mz"], charge=a["charge"])],
        mz=a["mz"], intensity=a["intensity"]))
        for i, a in enumerate(large_peak_arrays(db, 6, 12000, seed=31))]
    s = Scorer(db, _params(("ppm", -10.0, 10.0)), device=cuda)
    masses, intens, Pk = s._pad_peaks(spectra)
    assert Pk == 12000
    peaks = torch.from_numpy(masses).to(cuda)
    rng = np.random.default_rng(12)
    R, W = 40, 50
    p0 = rng.integers(0, len(db) - W, R)
    ints = np.stack([rng.integers(0, 6, R), p0, p0, p0 + W,
                     np.full(R, 4)]).astype(np.int32)
    got = _kernel_vs_plain_stage1(
        s.tables.lad_index, peaks, torch.from_numpy(ints).to(cuda), W=W,
        Lc=s.tables.L, Z=3, tol=("ppm", -10.0, 10.0))
    assert int(got[:, :W].max()) > 0
    n, k = 6, 20
    c = dict(lad=s.tables.lad_full.cpu().numpy(),
             pep=rng.integers(0, len(db), (n, k)).astype(np.int32),
             spec=np.arange(n, dtype=np.int32), pkm=masses, pki=intens,
             maxz=np.full((n, k), 4, np.int32),
             live=rng.integers(0, k + 1, n).astype(np.int32),
             series=s.series, frag_tol=("ppm", -10.0, 10.0), Z=3)
    got = _rescore_indexed_on_card(c, cuda)
    assert int(got[0].sum() + got[1].sum()) > 0


@pytest.mark.parametrize("fused", ["1", "0"])
def test_scorer_at_12000_peaks_card_matches_cpu(cuda, small, monkeypatch,
                                                fused):
    """The Scorer on spectra of 12,000 peaks (max_peaks 12,000) with
    fragment charges up to 3, fused and two-dispatch: every FeatureTable
    column equal to the CPU's, the stage-1 and rescore kernels
    launched."""
    import dataclasses

    from sage_tpu_torch.spectrum.processor import (Precursor, RawSpectrum,
                                                   SpectrumProcessor)

    db, _ = small
    monkeypatch.setenv("SAGE_TPU_FUSED", fused)
    proc = SpectrumProcessor(12000, False)
    spectra = [proc.process(RawSpectrum(
        ms_level=2, id=f"scan={i}", centroid=True,
        precursors=[Precursor(mz=a["prec_mz"], charge=a["charge"])],
        mz=a["mz"], intensity=a["intensity"]))
        for i, a in enumerate(large_peak_arrays(db, 4, 12000, seed=33))]
    params = dataclasses.replace(
        _params(("ppm", -10.0, 10.0)), max_fragment_charge=3,
        precursor_tol=Tolerance("ppm", -20.0, 20.0))
    before = (pallas_stage1.launches, trescore.launches)
    t_gpu = Scorer(db, params, device=cuda).score_table(spectra)
    assert pallas_stage1.launches > before[0]
    assert trescore.launches > before[1]
    t_cpu = Scorer(db, params, device="cpu").score_table(spectra)
    _assert_same([t_gpu], [t_cpu])


# ---- the peak-major searches' kernels ---------------------------------------

_PEAK_TOLS = {"ppm": ("ppm", -10.0, 10.0), "pct": ("pct", -0.001, 0.002),
              "da": ("da", -0.02, 0.02)}


def _one_launch(name, fn):
    """Call ``fn`` and check that it launched kernel ``name`` once."""
    before = topen.launches[name]
    out = fn()
    torch.cuda.synchronize()
    assert topen.launches[name] == before + 1, name
    return out


@pytest.mark.parametrize("form", ["grid", "slots", "banded"])
@pytest.mark.parametrize("Zb", [1, 3])
@pytest.mark.parametrize("tol", sorted(_PEAK_TOLS))
def test_peak_ranges_kernel_matches_plain(cuda, tol, Zb, form):
    """csrc/peak_ranges.cu, both forms, against its plain versions on the
    card: peaks whose fragments lie on their IEEE bounds and one ulp
    either side, NaN, -inf, 0 and +inf pads, invalid slots, an empty band;
    starts and lengths equal (i32)."""
    t = _PEAK_TOLS[tol]
    frag_mz, off, cs = pc.range_masses(t, seed=Zb)
    nb = off.size - 1
    B, Pk = 7, 16
    masses = pc.range_peaks(cs, B, Pk, seed=Zb)
    rng = np.random.default_rng(Zb)
    peaks = torch.from_numpy(np.stack([masses, np.ones_like(masses)])).to(
        cuda)
    if form == "banded":
        nbcov = 3
        bands = np.clip(rng.integers(0, nb, B)[:, None] + np.arange(nbcov),
                        0, nb - 1)
        valid = rng.random((B, nbcov)) < 0.8
        bb = np.zeros((B, nbcov, 2), np.int32)
        bb[:, :, 0] = off[bands]
        bb[:, :, 1] = np.where(valid, off[bands + 1], off[bands])
        args = (torch.from_numpy(frag_mz).to(cuda), peaks[0],
                torch.from_numpy(bb).to(cuda))
        kw = dict(Zb=Zb, tol=t, nstep=int(np.ceil(np.log2(
            np.diff(off).max()))) + 2)
        got = _one_launch("peak_ranges",
                          lambda: tbanded._banded_ranges(*args, **kw))
        want = tbanded._banded_ranges_plain(*args, **kw)
    else:
        tabs = pc.open_range_tables(topen, frag_mz, off, cuda)
        if form == "grid":
            band = torch.from_numpy(rng.integers(0, nb, (B, 3))).to(cuda)
            valid = torch.from_numpy(rng.random((B, 3)) < 0.8).to(cuda)
            args = (tabs, peaks, band, valid)
            run, plain = topen._device_ranges, topen._device_ranges_plain
        else:
            NS = 11
            args = (tabs, peaks,
                    torch.from_numpy(rng.integers(0, B, NS)).to(cuda),
                    torch.from_numpy(rng.integers(0, nb, NS)).to(cuda),
                    torch.from_numpy(rng.random(NS) < 0.8).to(cuda))
            run = topen._device_ranges_flat
            plain = topen._device_ranges_flat_plain
        got = _one_launch("peak_ranges", lambda: run(*args, Zb=Zb, tol=t))
        want = plain(*args, Zb=Zb, tol=t)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert int(want[1].sum()) > 0


def _entries_on_card(cuda, pep, starts, lens, **kw):
    """The gather on the card against its plain version: keys, tags and
    live counts equal; the live counts are the rows' live keys."""
    args = [torch.from_numpy(a).to(cuda)
            for a in (pep.reshape(-1, 64), starts, lens)]
    got = _one_launch("open_entries", lambda: topen.open_entries(*args, **kw))
    want = topen.open_entries_plain(*args, **kw)
    assert torch.equal(got[0], want[0])
    assert (got[1] is None) == (want[1] is None)
    assert got[1] is None or torch.equal(got[1], want[1])
    assert torch.equal(got[2], want[2])
    np.testing.assert_array_equal(
        got[2].cpu().numpy(), pc.live_count(got[0].cpu().numpy(),
                                            kw["packed"]))
    return want


@pytest.mark.parametrize("overflow", [False, True], ids=["fits", "overflow"])
@pytest.mark.parametrize("packed", [True, False], ids=["packed", "neg"])
@pytest.mark.parametrize("nbcov", [1, 3, 10])
@pytest.mark.parametrize("Z", [1, 3])
@pytest.mark.parametrize("chunked", [False, True], ids=["flat", "chunked"])
def test_open_entries_kernel_matches_plain(cuda, chunked, Z, nbcov, packed,
                                           overflow):
    """csrc/open_entries.cu against its plain version on the card: every
    key, tag (the unpacked form's, pads included) and live count equal,
    rows past F (or Wc table rows) included, nbcov up to the open path's
    10."""
    Pk, F, Wc = 8, 384, 8
    pep, starts, lens = pc.entries_case(
        Z * 10 + nbcov, B=5, nbcov=nbcov, Z=Z, Pk=Pk, chunked=chunked, F=F,
        Wc=Wc, overflow=overflow)
    _entries_on_card(cuda, pep, starts, lens, F=F, Wc=Wc, Pk=Pk, Z=Z,
                     nbcov=nbcov, chunked=chunked, packed=packed)


@pytest.mark.parametrize("packed", [True, False], ids=["packed", "neg"])
@pytest.mark.parametrize("chunked", [False, True], ids=["flat", "chunked"])
def test_open_entries_kernel_12000_peaks(cuda, chunked, packed):
    """The gather at 12,000 peaks with Z 3 (36,000 windows a row, 18
    tiles of 2048): keys, tags and live counts equal to the plain
    version, a row past F among them."""
    Pk, Z, nbcov = 12000, 3, 2
    F, Wc = 4096, 1024
    rng = np.random.default_rng(12000 + chunked)
    N = 1 << 16
    pep = rng.integers(0, 50000, N).astype(np.int32)
    pep[-70:] = -1
    starts = rng.integers(0, N - 80, (3, Z * nbcov * Pk)).astype(np.int32)
    lens = (rng.random(starts.shape) < 0.02).astype(np.int32) * \
        rng.integers(1, 4, starts.shape).astype(np.int32)
    lens[0, : Z * Pk] = 1  # spectrum 0's first band: past F and Wc rows
    _entries_on_card(cuda, pep, starts, lens, F=F, Wc=Wc, Pk=Pk, Z=Z,
                     nbcov=nbcov, chunked=chunked, packed=packed)


def _count_on_card(cuda, case, **kw):
    rows, zs, *q = case
    args = [torch.from_numpy(a).to(cuda) for a in (rows,)] + [
        None if zs is None else torch.from_numpy(zs).to(cuda)] + [
        torch.from_numpy(a).to(cuda) for a in q]
    got = _one_launch("open_count", lambda: topen.open_count(*args, **kw))
    want = topen.open_count_plain(*args, **kw)
    assert torch.equal(got, want)
    return want


@pytest.mark.parametrize("max_run", [3, 40])
@pytest.mark.parametrize("K", [50, 80, 1024])
@pytest.mark.parametrize("packed", [True, False], ids=["packed", "neg"])
@pytest.mark.parametrize("nbcov", [1, 4, 10])
@pytest.mark.parametrize("Z", [1, 3])
def test_open_count_kernel_matches_plain(cuda, Z, nbcov, packed, K,
                                         max_run):
    """csrc/open_count.cu against its plain version on the card (both sort
    branches' keys, both forms: a warp a query row at K 50, a block at 80
    and 1024): ties, padding rows, a row cut at F, an empty row,
    every-band ranges, nbcov up to the open path's 10, runs of up to 40
    entries (open across the warp form's 32-position steps); the
    [R, 2K+2] rows equal. F is at least K, as every caller's is."""
    F = max(512, K)
    W = F + 128
    case = pc.count_case(Z + 7 * nbcov + K, B=6, nbcov=nbcov, F=F, W=W, Z=Z,
                         packed=packed, R=40, max_run=max_run)
    want = _count_on_card(cuda, case, F=F, K=K, nbcov=nbcov, Z=Z,
                          packed=packed)
    if max_run == 3:
        assert int((want[:, min(K, 80) - 1] > 0).sum()) > 0
    else:  # a run counted over more than one 32-position step
        assert int(want[:, 0].max()) > 32


@pytest.mark.parametrize("K", [50, 64, 1024])
def test_open_count_kernel_compacts(cuda, K):
    """Rows of 12,000 runs in one query row's window: the kernel's top-K
    buffer (128 keys a warp at K 50 and 64, 4096 a block at 1024) fills
    and compacts many times; equal to the plain version."""
    F = W = 16384
    case = pc.count_case(5, B=3, nbcov=1, F=F, W=W, Z=1, packed=True, R=6,
                         band_w=20000, max_run=1)
    rows, zs, live, spec, i0, i1, maxz = case
    i0[:], i1[:] = 0, 20000
    spec[:] = [0, 2] * 3  # pseudo-row 1 holds no entries
    want = _count_on_card(cuda, case, F=F, K=K, nbcov=1, Z=1, packed=True)
    assert int(want[:, 2 * K + 1].min()) > 4096


def _peak_launches():
    return dict(topen.launches)


# the card paths of the three kernels: (environment, plan key)
_PEAK_PATHS = {
    "open": ({"SAGE_TPU_OPEN_THRESHOLD": "1"}, "open"),
    "open_two_dispatch": ({"SAGE_TPU_OPEN_THRESHOLD": "1",
                           "SAGE_TPU_FUSED": "0"}, None),
    "open_torch_sort": ({"SAGE_TPU_OPEN_THRESHOLD": "1"}, "open"),
    "banded": ({"SAGE_TPU_NARROW_BANDED": "1",
                "SAGE_TPU_NARROW_BAND_W": "64"}, "banded"),
}


@pytest.mark.parametrize("path", sorted(_PEAK_PATHS))
def test_peak_paths_launch_kernels(cuda, small, monkeypatch, path):
    """The open search (fused and two-dispatch, and with every entry row
    sorted by torch.sort) and the banded narrow stage 1 on the card run
    all three kernels (the launch counters grow) and give every
    FeatureTable column of the CPU."""
    db, spectra = small
    env, kind = _PEAK_PATHS[path]
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    if path == "open_torch_sort":
        monkeypatch.setattr(topen, "use_pallas_sort", lambda F, n: False)
    if kind != "banded":
        params = SearchParams(
            precursor_tol=Tolerance("da", -500.0, 100.0),
            fragment_tol=Tolerance("ppm", -10.0, 10.0), report_psms=2)
    else:
        params = _params(("ppm", -10.0, 10.0))
    tables = {}
    for dev in (cuda, torch.device("cpu")):
        before = _peak_launches()
        s = Scorer(db, params, device=dev)
        tables[dev.type] = list(s.score_stream([spectra[:96],
                                                spectra[96:192]]))
        grew = {k: topen.launches[k] - before[k] for k in before}
        assert kind is None or s.last_plan.get(kind)
        if dev.type == "cuda":
            assert all(n > 0 for n in grew.values()), grew
        else:
            assert not any(grew.values()), grew
    _assert_same(tables["cuda"], tables["cpu"])


def test_grid_open_launches_kernels(cuda, small, monkeypatch):
    """The grid's banded open step on four shards of the one card runs
    the range search (its planning), the entry gather and the count
    kernels, and gives every FeatureTable column of the CPU."""
    from sage_tpu_torch.parallel import sharding

    db, spectra = small
    monkeypatch.setenv("SAGE_TPU_SHARD_WINDOWED", "0")
    monkeypatch.setenv("SAGE_TPU_SHARD_OPEN", "1")
    params = _params(("ppm", -10.0, 10.0))
    mesh = sharding.make_mesh(2, 2, devices=[cuda] * 4)
    sc = sharding.ShardedScorer(db, mesh, params)
    before = _peak_launches()
    t_gpu = sc.score_table(spectra[:96])
    torch.cuda.synchronize()
    assert sc.last_route[0] == "open"
    assert all(topen.launches[k] > before[k] for k in before), before
    t_cpu = Scorer(db, params, device="cpu").score_table(spectra[:96])
    _assert_same([t_gpu], [t_cpu])


def _prep_case(rng, S, P):
    """A batch at the narrow cell's shapes: S spectra of 0-150 peaks (one
    of 160, so Pk is a multiple of 32), P ascending f32 peptide masses
    with runs of equal ones, and five isotope rows a spectrum whose
    bounds hold masses of the table, values between them, values off
    both ends, +-inf and NaN."""
    lens = rng.integers(0, 151, S)
    lens[S // 2] = 160
    N = int(lens.sum())
    masses = np.sort(rng.uniform(150.0, 4000.0, N)).astype(np.float32)
    intens = rng.uniform(1.0, 1e6, N).astype(np.float32)
    mono = np.sort(np.repeat(rng.uniform(500.0, 5000.0, P // 2), 2)
                   .astype(np.float32))
    R = 5 * S
    lo = rng.uniform(400.0, 5100.0, R).astype(np.float32)
    pick = rng.random(R) < 0.25
    lo[pick] = mono[rng.integers(0, P, int(pick.sum()))]
    hi = (lo + np.float32(0.05)).astype(np.float32)
    pick = rng.random(R) < 0.25
    hi[pick] = mono[rng.integers(0, P, int(pick.sum()))]
    lo[:4] = (-np.inf, np.inf, np.nan, 1.0)
    hi[:4] = (np.inf, np.inf, np.nan, 9000.0)
    offs = np.r_[0, np.cumsum(lens)].astype(np.int32)
    return masses, intens, offs, lo, hi, mono, lens


def test_batch_prep_kernel_matches_plain_and_host(cuda):
    """The batch_prep kernel at the narrow cell's shapes (8,192 spectra,
    40,960 rows, 2 M peptide masses) against its plain version and the
    host's padding and np.searchsorted: bit-equal block and ranges, one
    launch."""
    rng = np.random.default_rng(18)
    S, P = 8192, 1 << 21
    masses, intens, offs, lo, hi, mono, lens = _prep_case(rng, S, P)
    Pk = tprep.padded_width(lens)
    assert Pk == 160
    mono_pad = np.r_[mono, np.full(2048, np.inf, np.float32)]
    args = [torch.from_numpy(a) for a in (masses, intens, offs, lo, hi,
                                          mono_pad)]
    before = tprep.launches
    peaks, i01 = tprep.batch_prep(*[a.to(cuda) for a in args], P=P, Pk=Pk)
    torch.cuda.synchronize()
    assert tprep.launches == before + 1
    p_peaks, p_i01 = tprep.batch_prep_plain(*args, P=P, Pk=Pk)
    assert torch.equal(peaks.cpu().view(torch.int32),
                       p_peaks.view(torch.int32))
    assert torch.equal(i01.cpu(), p_i01)
    hm, hi_ = tprep.pad_flat(masses, intens, lens, Pk)
    np.testing.assert_array_equal(peaks[0].cpu().numpy().view(np.uint32),
                                  hm.view(np.uint32))
    np.testing.assert_array_equal(peaks[1].cpu().numpy().view(np.uint32),
                                  hi_.view(np.uint32))
    np.testing.assert_array_equal(i01[0].cpu().numpy(),
                                  np.searchsorted(mono, lo, side="left"))
    np.testing.assert_array_equal(i01[1].cpu().numpy(),
                                  np.searchsorted(mono, hi, side="right"))


@pytest.mark.parametrize("path", ["narrow", "open"])
def test_stream_prep_launches_and_host_pads(cuda, small, monkeypatch, path):
    """score_stream on the card launches batch_prep once a batch; the
    host pads no batch on the narrow fused path and pads the open path's
    (its plan reads the padded masses); every FeatureTable column equals
    the CPU's."""
    db, spectra = small
    if path == "open":
        monkeypatch.setenv("SAGE_TPU_OPEN_THRESHOLD", "1")
        params = SearchParams(
            precursor_tol=Tolerance("da", -500.0, 100.0),
            fragment_tol=Tolerance("ppm", -10.0, 10.0), report_psms=2)
    else:
        params = _params(("ppm", -10.0, 10.0))
    batches = [spectra[:96], spectra[96:192], spectra[192:]]
    c0 = trace.counters()
    gpu = Scorer(db, params, device=cuda)
    t_gpu = list(gpu.score_stream(batches))
    c1 = trace.counters()
    grew = {k: c1.get(k, 0) - c0.get(k, 0)
            for k in ("launch.batch_prep", "search.host_pad")}
    assert grew["launch.batch_prep"] == len(batches), grew
    assert bool(gpu.last_plan.get("open")) == (path == "open")
    if path == "open":
        assert grew["search.host_pad"] > 0, grew
    else:
        assert grew["search.host_pad"] == 0, grew
    t_cpu = list(Scorer(db, params, device="cpu").score_stream(batches))
    _assert_same(t_gpu, t_cpu)

