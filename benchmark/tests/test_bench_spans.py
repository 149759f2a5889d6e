"""The readers of the program's spans and counters (``program_spans.py``
and its metrics) on ``_small``'s search cell, traced, on the CPU.

With the program's recorder on (started by hand, or by a profiler as in
a traced run on the card) every new metric reads a number, the build's
steps fit inside the benchmark's ``db_build`` span and a batch's spans
cover the benchmark's ``batch`` span. A program without the recorder
leaves the metrics out of the line and raises nothing."""

import numpy as np
import pytest

from _small import SIZES
from benchmark import program_spans, run

CELL = "tmt11-narrow.search"
SEARCH = ["search.prep_ms", "search.upload_ms", "search.upload_mib",
          "search.dispatch_ms", "search.fetch_wait_ms", "search.finalize_ms",
          "search.queue_wait_ms", "search.host_offcpu_pct"]
BUILD = ["db_build.digest_s", "db_build.fragments_s", "db_build.sort_s"]


def _traced(seed):
    size = SIZES[CELL]
    return run.run_cell(
        CELL, seed, 0.2, trace=True, device="cpu",
        proteome={"proteins": size["proteins"]},
        mix_over={"batch": size["spectra"] // 2, "judge_per_batch": 64},
        n_spectra=size["spectra"], warmup=False)


@pytest.mark.parametrize("how", ["start", "profiler"])
def test_span_metrics_read_numbers(how):
    from torch.profiler import ProfilerActivity, profile

    from sage_tpu_torch.utils import trace

    trace.start()
    try:
        if how == "profiler":
            trace.stop()  # records only while the profiler runs
            with profile(activities=[ProfilerActivity.CPU]):
                r = _traced(2147483651)
        else:
            r = _traced(2147483651)
        recs = trace.records()
    finally:
        trace.stop()
    assert r["correct"], r["checks"]
    m = {k: v["value"] for k, v in r["metrics"].items()}
    for name in SEARCH + BUILD:
        assert name in m and np.isfinite(m[name]) and m[name] >= 0, name
    assert m["search.upload_mib"] > 0 and m["search.prep_ms"] > 0
    assert m["search.host_offcpu_pct"] <= 100
    assert sum(m[k] for k in BUILD) <= m["db_build_s"]
    assert {x["name"] for x in recs} >= {"db.build", "search.prep",
                                         "search.wait", "search.fetch"}


def test_batch_spans_cover_the_benchmark_batch():
    """Each ``batch`` span of the benchmark (handed in to yielded) is
    covered by its batch's top-level program spans: prep, dispatch,
    the waits, fetch, finalize."""
    import torch

    from benchmark import drivers, program
    from sage_tpu_torch.utils import trace

    bench = run.load_bench()
    _, config, mix = run.cell_spec(bench, CELL)
    size = SIZES[CELL]
    config["proteome"]["proteins"] = size["proteins"]
    mix.update(batch=size["spectra"] // 2, judge_per_batch=16)
    trace.start()
    try:
        out = drivers.run_search(config, mix, 7, 0.5, False, "cpu", torch,
                                 program, n_spectra=size["spectra"],
                                 warmup=False)
    finally:
        recs, _ = trace.stop()
    tops = {}
    for x in recs:
        if x["batch"] is not None and x["parent"] is None:
            tops.setdefault(x["batch"], []).append(x)
    prep = {min(x["start_ns"] for x in xs if x["name"] == "search.prep"): xs
            for xs in tops.values()}
    shares = []
    for a, b in out.spans.by_name["batch"]:
        # the batch handed in at a: the first admitted after it
        mine = prep[min(t for t in prep if t >= a)]
        inside = sum(min(x["end_ns"], b) - max(x["start_ns"], a)
                     for x in mine if x["end_ns"] > a and x["start_ns"] < b)
        shares.append(inside / (b - a))
    assert len(shares) >= 2 and max(shares) <= 1.0 + 1e-9
    assert float(np.median(shares)) >= 0.9, shares


def test_readers_without_the_recorder(monkeypatch):
    monkeypatch.setattr(program_spans, "_recorder", lambda: None)
    r = _traced(5)
    assert r["correct"]
    assert not set(SEARCH + BUILD) & set(r["metrics"])
    assert "db_build_s" in r["metrics"]
