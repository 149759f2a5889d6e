"""The port's spans and counters (``utils/trace.py``) and where the search,
the database build and the Runner put them.

Off, a span keeps no record and adds to its name's total; on, records
nest by thread and come back on ``time.time_ns``'s clock. A search with
the recorder on yields the same tables as with it off, on both of
``pipeline_stream``'s loops and on the fused and two-dispatch paths,
and every batch's spans follow one another with no overlap. On the
card (``gpu`` marker) a kernel launched inside a span starts inside it
in ``torch.profiler``'s device trace."""

import json
import os
import threading
import time

import numpy as np
import pytest
import torch

from sage_tpu_torch.chem.fasta import Fasta
from sage_tpu_torch.chem.mass import PROTON, Tolerance
from sage_tpu_torch.index.builder import DatabaseParams
from sage_tpu_torch.ops.search import Scorer, SearchParams
from sage_tpu_torch.pipeline import runner as runner_mod
from sage_tpu_torch.spectrum.processor import Precursor, ProcessedSpectrum
from sage_tpu_torch.utils import trace

AA = np.frombuffer(b"ACDEFGHIKLMNPQRSTVWY", dtype=np.uint8)


@pytest.fixture
def recording():
    trace.start()
    try:
        yield
    finally:
        trace.stop()


def _fasta(n_prot, length, seed):
    rng = np.random.default_rng(seed)
    return "\n".join(
        f">sp|T{i:04d}|T{i}_SYN synthetic\n"
        + AA[rng.integers(0, len(AA), size=length)].tobytes().decode()
        for i in range(n_prot))


def _spectra(db, n, seed):
    """``n`` processed spectra from ``db``'s b/y ladders plus noise."""
    rng = np.random.default_rng(seed)
    b, y = db.table.ladders()
    targets = np.flatnonzero(db.table.lens >= 7)
    out = []
    for i in range(n):
        p = int(targets[rng.integers(0, targets.size)])
        k = int(db.table.lens[p]) - 1
        frags = np.concatenate([b[p, :k], y[p, :k]])
        frags = frags[rng.random(frags.size) < 0.8]
        noise = rng.uniform(150.0, float(db.table.mono[p]), 20)
        masses = np.sort(np.concatenate([frags, noise]).astype(np.float32))
        intens = rng.uniform(1.0, 1e5, masses.size).astype(np.float32)
        z = 2 + i % 2
        out.append(ProcessedSpectrum(
            level=2, id=f"scan={i}", file_id=0, scan_start_time=0.1 * i,
            ion_injection_time=1.0,
            precursors=[Precursor(mz=float(db.table.mono[p]) / z
                                  + float(PROTON), charge=z)],
            masses=masses, intensities=intens,
            mobilities=np.zeros(0, np.float32),
            total_ion_current=np.float32(intens.sum())))
    return out


@pytest.fixture(scope="module")
def db():
    dbp = DatabaseParams()
    return dbp.build(Fasta.parse(_fasta(40, 260, seed=13), dbp.decoy_tag,
                                 True))


def _scorer(db):
    return Scorer(db, SearchParams(
        precursor_tol=Tolerance("da", -60.0, 60.0),
        fragment_tol=Tolerance("ppm", -10.0, 10.0), report_psms=2,
        min_matched_peaks=1), device="cpu")


def test_off_keeps_no_record_and_adds_to_totals():
    assert not torch.autograd.profiler._is_profiler_enabled
    before = trace.totals().get("test.off", 0.0)
    kept = len(trace.records())
    with trace.span("test.off") as s:
        time.sleep(0.002)
    assert s.ns >= 2_000_000
    assert trace.totals()["test.off"] - before >= 0.002
    assert len(trace.records()) == kept
    trace.count("test.off_count", 3)
    assert trace.counters()["test.off_count"] >= 3


def test_on_spans_nest_by_thread(recording):
    t_lo = time.time_ns()
    together = threading.Barrier(3, timeout=30)

    def work(bid, barrier=None):
        with trace.span("test.outer", bid):
            if barrier is not None:
                barrier.wait()  # all three alive at once: distinct idents
            with trace.span("test.inner"):
                trace.count("test.bytes", 5)
                time.sleep(0.001)

    threads = [threading.Thread(target=work, args=(100 + i, together))
               for i in range(3)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30)
        assert not t.is_alive()
    work(None)
    t0 = trace.clock()
    trace.interval("test.wait", t0, 7)
    recs, grown = trace.stop()
    t_hi = time.time_ns()
    by_id = {r["id"]: r for r in recs}
    outers = [r for r in recs if r["name"] == "test.outer"]
    inners = [r for r in recs if r["name"] == "test.inner"]
    assert len(outers) == len(inners) == 4
    for r in inners:
        parent = by_id[r["parent"]]
        assert parent["name"] == "test.outer"
        assert parent["thread"] == r["thread"]
        assert r["batch"] == parent["batch"]
        assert parent["start_ns"] <= r["start_ns"] <= r["end_ns"] <= parent["end_ns"]
        assert r["counts"] == {"test.bytes": 5}
        assert 0 <= r["cpu_ns"]
    assert sorted(r["batch"] for r in outers if r["batch"] is not None) == \
        [100, 101, 102]
    assert all(r["parent"] is None for r in outers)
    assert len({r["thread"] for r in outers}) == 4
    for r in recs:
        assert t_lo <= r["start_ns"] <= r["end_ns"] <= t_hi
    (wait,) = [r for r in recs if r["name"] == "test.wait"]
    assert wait["batch"] == 7 and wait["cpu_ns"] is None
    assert grown["test.bytes"] == 20
    assert trace.records() == []


def test_profiler_keeps_records():
    from torch.profiler import ProfilerActivity, profile

    trace.stop()
    with profile(activities=[ProfilerActivity.CPU]):
        with trace.span("test.profiled", 5):
            pass
    kept = [r for r in trace.records() if r["name"] == "test.profiled"]
    assert len(kept) == 1 and kept[0]["batch"] == 5
    with trace.span("test.profiled"):
        pass
    assert len([r for r in trace.records()
                if r["name"] == "test.profiled"]) == 1
    trace.stop()


@pytest.mark.parametrize("fused", ["1", "0"])
@pytest.mark.parametrize("cores", [1, 8])
def test_stream_spans_per_batch(db, monkeypatch, cores, fused):
    """Tables equal with the recorder on and off; each batch id has one
    prep, one dispatch and one finalize a device pass (two on the
    two-dispatch path), at least one fetch, and its spans one after
    another: prep, dispatch, then the other thread's stages."""
    monkeypatch.setenv("SAGE_TPU_OPEN_THRESHOLD", "999999999")
    monkeypatch.setenv("SAGE_TPU_FUSED", fused)
    monkeypatch.setattr(os, "cpu_count", lambda: cores)
    spectra = _spectra(db, 9, seed=8)
    cuts = [(0, 4), (4, 6), (6, 9)]
    off = list(_scorer(db).score_stream([spectra[a:b] for a, b in cuts]))
    scorer = _scorer(db)  # its tables' uploads belong to no batch
    trace.start()
    try:
        on = list(scorer.score_stream([spectra[a:b] for a, b in cuts]))
    finally:
        recs, grown = trace.stop()
    assert len(on) == len(off) == 3
    for a, b in zip(on, off):
        assert len(a) > 0 and a.spec_ids == b.spec_ids
        for k in a.columns:
            np.testing.assert_array_equal(a.columns[k], b.columns[k])
    passes = 1 if fused == "1" else 2
    bids = sorted({r["batch"] for r in recs if r["name"] == "search.prep"})
    assert len(bids) == 3
    up = 0
    for bid in bids:
        mine = [r for r in recs if r["batch"] == bid]
        names = [r["name"] for r in mine]
        assert names.count("search.prep") == 1
        assert names.count("search.dispatch") == passes
        assert names.count("search.finalize") == passes
        assert names.count("search.fetch") >= 1
        assert names.count("search.wait") == 2
        assert names.count("search.upload") >= 1
        up += sum(r.get("counts", {}).get("search.upload_bytes", 0)
                  for r in mine)
        top = sorted((r for r in mine if r["parent"] is None),
                     key=lambda r: r["start_ns"])
        assert [r["name"] for r in top[:2]] == ["search.prep",
                                                "search.dispatch"]
        for x, y in zip(top, top[1:]):
            assert x["end_ns"] <= y["start_ns"], (x, y)
    assert up == grown["search.upload_bytes"] > 0


def test_database_build_spans(recording):
    dbp = DatabaseParams()
    dbp.build(Fasta.parse(_fasta(5, 200, seed=3), dbp.decoy_tag, True))
    recs = trace.records()
    (build,) = [r for r in recs if r["name"] == "db.build"]
    kids = {r["name"] for r in recs if r["parent"] == build["id"]}
    assert kids == {"db.digest", "db.fragments", "db.sort"}


def _write_mgf(path, db, n, seed):
    rng = np.random.default_rng(seed)
    reporters = [126.127726, 127.124761, 128.134436]
    lines = []
    for i, s in enumerate(_spectra(db, n, seed)):
        mz = np.concatenate([s.masses + float(PROTON), reporters])
        inten = np.concatenate([s.intensities, rng.uniform(1e4, 1e6, 3)])
        order = np.argsort(mz)
        lines += ["BEGIN IONS", f"TITLE=scan={i + 1}",
                  f"PEPMASS={s.precursors[0].mz!r}",
                  f"CHARGE={s.precursors[0].charge}+",
                  f"RTINSECONDS={6.0 * i + 30.0!r}"]
        lines += [f"{float(m)!r} {float(v)!r}"
                  for m, v in zip(mz[order], inten[order])]
        lines.append("END IONS")
    path.write_text("\n".join(lines) + "\n")


def test_runner_phases_keep_their_keys(db, tmp_path, caplog):
    from sage_tpu_torch.pipeline.input import build_search

    text = _fasta(40, 260, seed=13)
    (tmp_path / "db.fasta").write_text(text)
    _write_mgf(tmp_path / "run.mgf", db, 48, seed=43)
    cfg = {"database": {"fasta": str(tmp_path / "db.fasta")},
           "mzml_paths": [str(tmp_path / "run.mgf")],
           "precursor_tol": {"da": [-60, 60]},
           "fragment_tol": {"ppm": [-10, 10]}, "min_peaks": 10,
           "quant": {"tmt": "Tmt6", "tmt_settings": {"level": 2}}}
    runner = runner_mod.Runner(
        build_search(json.loads(json.dumps(cfg)),
                     output_directory=str(tmp_path / "out")), device="cpu")
    with caplog.at_level("INFO", logger="sage_tpu_torch"):
        result = runner.run()
    old = {"db_build_s", "read_s", "process_s", "search_s", "rt_ml_s",
           "fdr_s", "quant_s", "write_s"}
    assert set(result["phases"]) == old | {"lda_s"}
    ph = runner.phases
    assert set(ph) == old | {"lda_s"}
    for k in ("db_build_s", "read_s", "search_s", "fdr_s", "lda_s",
              "quant_s", "write_s"):
        assert ph[k] > 0, k
    assert ph["lda_s"] <= ph["fdr_s"]
    again = runner.run()["phases"]
    assert again["search_s"] > result["phases"]["search_s"]
    assert again["db_build_s"] == result["phases"]["db_build_s"]
    line = [r.getMessage() for r in caplog.records
            if r.getMessage().startswith("kernel launches:")][0]
    assert [w.split("=")[0] for w in line.split()[2:]] == \
        list(runner_mod.KERNELS)


def test_launch_snapshot_has_every_kernel():
    snap = runner_mod._kernel_launches()
    assert set(snap) == {"stage1_counts", "row_sort", "cluster_sort",
                         "rescore", "peak_ranges", "open_entries",
                         "open_count", "batch_prep"}
    trace.count("launch.open_count", 2)
    assert runner_mod._kernel_launches()["open_count"] == \
        snap["open_count"] + 2


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.gpu
def test_kernel_starts_inside_its_span(cuda):
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    x = torch.rand((2048, 2048), device=cuda)
    (x @ x).sum().item()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        # a kernel ahead of the span: the profiler can lose the first
        # records of a window
        x.add_(0.0)
        torch.cuda.synchronize()
        time.sleep(0.01)
        with trace.span("test.kernel"):
            y = x @ x
            torch.cuda.synchronize()
        time.sleep(0.01)
    (rec,) = [r for r in trace.records() if r["name"] == "test.kernel"]
    trace.stop()
    starts = sorted(int(e.start_ns())
                    for e in prof.profiler.kineto_results.events()
                    if e.device_type() == DeviceType.CUDA)
    assert starts and y.shape == x.shape
    # the matmul, the last kernel, starts inside the span; none between
    inside = [t for t in starts if t >= rec["start_ns"]]
    assert inside and all(t <= rec["end_ns"] for t in inside), (starts, rec)
