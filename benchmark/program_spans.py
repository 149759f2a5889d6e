"""The program's own spans and counters, for the per-layer metrics that
split a batch and the database build.

The program keeps them in ``sage_tpu_torch.utils.trace``: each span's
name, batch id, thread, parent, start and end (on ``time.time_ns``'s
clock, as the profiler's device events), the thread's CPU time over it
and the counts added inside it. It keeps a record of every span while
``torch.profiler`` profiles the process, so a traced run's window has
one for every span of its batches; every span adds to its name's total
seconds, records or not. A program without the recorder gives nothing
here, and the metrics that read it are left out of the line.

A batch's time in a span name is the sum over its spans of that name;
self time leaves out the part the span's children cover. A metric is
the median over the window's batches: those whose ``search.prep`` began
inside the window.
"""

from __future__ import annotations

import sys
from typing import Dict, List, Optional

import numpy as np


def _recorder():
    """The program's recorder, where the program under test (loaded by
    ``program.py``) has one."""
    return sys.modules.get("sage_tpu_torch.utils.trace")


def _records() -> List[dict]:
    rec = _recorder()
    return rec.records() if rec is not None else []


def batches(facts) -> Dict[int, List[dict]]:
    """The window's batches' records, by batch id."""
    t0 = facts["window_start_ns"]
    by: Dict[int, List[dict]] = {}
    for r in _records():
        if r["batch"] is not None:
            by.setdefault(r["batch"], []).append(r)
    return {b: rs for b, rs in by.items()
            if any(r["name"] == "search.prep" and r["start_ns"] >= t0
                   for r in rs)}


def _children(recs: List[dict]) -> Dict[int, List[dict]]:
    kids: Dict[int, List[dict]] = {}
    for r in recs:
        if r["parent"] is not None:
            kids.setdefault(r["parent"], []).append(r)
    return kids


def _median(values: List[float]) -> Optional[float]:
    return float(np.median(values)) if values else None


def batch_ms(facts, name: str, self_time: bool = False) -> Optional[float]:
    """Median over the window's batches of the milliseconds a batch spent
    in spans named ``name`` (their self time where ``self_time``)."""
    out = []
    for recs in batches(facts).values():
        kids = _children(recs)
        ns = 0
        for r in recs:
            if r["name"] != name:
                continue
            ns += r["end_ns"] - r["start_ns"]
            if self_time:
                ns -= sum(k["end_ns"] - k["start_ns"]
                          for k in kids.get(r["id"], ()))
        out.append(ns / 1e6)
    return _median(out)


def batch_count(facts, counter: str) -> Optional[float]:
    """Median over the window's batches of a counter's growth a batch."""
    return _median([float(sum(r.get("counts", {}).get(counter, 0)
                              for r in recs))
                    for recs in batches(facts).values()])


def batch_offcpu_pct(facts, names) -> Optional[float]:
    """Median over the window's batches of 100 x (1 - thread CPU time /
    wall time) over the self time of the spans named ``names``: the
    share of the host's own work in them spent off the CPU (waiting for
    the interpreter lock or the scheduler)."""
    out = []
    for recs in batches(facts).values():
        kids = _children(recs)
        wall = cpu = 0
        for r in recs:
            if r["name"] not in names:
                continue
            wall += r["end_ns"] - r["start_ns"]
            cpu += r["cpu_ns"]
            for k in kids.get(r["id"], ()):
                wall -= k["end_ns"] - k["start_ns"]
                cpu -= k["cpu_ns"] or 0
        if wall > 0:
            out.append(100.0 * (1.0 - cpu / wall))
    return _median(out)


def build_s(facts, name: str) -> Optional[float]:
    """Seconds of the database build's step ``name``: its records inside
    the benchmark's ``db_build`` span where the build was recorded, else
    the program's total for the name (the run builds one database)."""
    spans = facts["spans"].by_name.get("db_build", [])
    recs = [r for r in _records() if r["name"] == name]
    if spans and recs:
        a, b = spans[0]
        inside = [r for r in recs if a <= r["start_ns"] and r["end_ns"] <= b]
        if inside:
            return sum(r["end_ns"] - r["start_ns"] for r in inside) / 1e9
    rec = _recorder()
    return rec.totals().get(name) if rec is not None else None
