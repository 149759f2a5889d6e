"""Spans and counters of the port, kept in memory.

``span(name, batch)`` times a piece of host work. It always adds its
wall time to a per-name total (:func:`totals`), which costs two clock
reads and one locked add. While records are kept it also keeps a record
of the span: its name, its batch id (given, or the enclosing span's on
the same thread), its thread, its parent (the span open on the same
thread when it began), its start and end, and the thread's CPU time
over it. ``count(name, n)`` adds to a named counter, and to the record
of the span open on its thread.

Records are kept between :func:`start` and :func:`stop`, and while
``torch.profiler`` profiles the process, so that a profiled window's
host time can be named by the program's spans without a second switch;
:func:`records` reads those without clearing them. Record times are in
``time.time_ns`` nanoseconds, the clock of the profiler's device events:
the spans read the monotonic clock, shifted by one offset taken when
the records began, so durations stay monotonic.

No exporter and no setting: a caller reads the records and writes them
where it wants.
"""

from __future__ import annotations

import itertools
import threading
import time
from typing import Dict, List, Optional, Tuple

from torch.autograd import profiler as _torch_profiler

_lock = threading.Lock()
_local = threading.local()
_totals: Dict[str, int] = {}  # name -> summed wall ns
_counters: Dict[str, int] = {}
_counters0: Dict[str, int] = {}  # the counters when start() ran
_records: List[dict] = []
_started = False
_offset = time.time_ns() - time.monotonic_ns()
_ids = itertools.count(1)
_batches = itertools.count(1)


def _recording() -> bool:
    return _started or getattr(_torch_profiler, "_is_profiler_enabled",
                               False)


def _stack() -> list:
    stack = getattr(_local, "stack", None)
    if stack is None:
        stack = _local.stack = []
    return stack


def clock() -> int:
    """The spans' clock (``time.monotonic_ns``), for :func:`interval`."""
    return time.monotonic_ns()


def new_batch() -> int:
    """A fresh batch id (ids are unique within the process)."""
    return next(_batches)


class span:
    """Context manager timing the work inside it under ``name``. After
    it closes, ``ns`` holds its wall nanoseconds."""

    __slots__ = ("name", "batch", "rec", "t0", "cpu0", "ns")

    def __init__(self, name: str, batch: Optional[int] = None):
        self.name = name
        self.batch = batch

    def __enter__(self) -> "span":
        self.rec = None
        if _recording():
            stack = _stack()
            parent = stack[-1] if stack else None
            batch = self.batch
            if batch is None and parent is not None:
                batch = parent["batch"]
            self.rec = {
                "id": next(_ids), "name": self.name, "batch": batch,
                "thread": threading.get_ident(),
                "parent": parent["id"] if parent is not None else None,
            }
            stack.append(self.rec)
            self.cpu0 = time.thread_time_ns()
        self.t0 = time.monotonic_ns()
        return self

    def __exit__(self, *exc) -> bool:
        t1 = time.monotonic_ns()
        self.ns = t1 - self.t0
        with _lock:
            _totals[self.name] = _totals.get(self.name, 0) + self.ns
        rec = self.rec
        if rec is not None:
            rec["cpu_ns"] = time.thread_time_ns() - self.cpu0
            stack = _stack()
            if stack and stack[-1] is rec:
                stack.pop()
            if _recording():
                rec["start_ns"] = self.t0 + _offset
                rec["end_ns"] = t1 + _offset
                with _lock:
                    _records.append(rec)
        return False


def interval(name: str, t0: int, batch: Optional[int] = None) -> None:
    """A span that began at ``t0`` (:func:`clock`), perhaps on another
    thread, and ends now: a wait. Its record has no CPU time."""
    t1 = time.monotonic_ns()
    with _lock:
        _totals[name] = _totals.get(name, 0) + t1 - t0
    if _recording():
        stack = _stack()
        parent = stack[-1] if stack else None
        rec = {
            "id": next(_ids), "name": name, "batch": batch,
            "thread": threading.get_ident(),
            "parent": parent["id"] if parent is not None else None,
            "start_ns": t0 + _offset, "end_ns": t1 + _offset, "cpu_ns": None,
        }
        with _lock:
            _records.append(rec)


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to the counter ``name`` (and, while records are kept, to
    the ``counts`` of the span open on this thread)."""
    with _lock:
        _counters[name] = _counters.get(name, 0) + n
    if _recording():
        stack = _stack()
        if stack:
            counts = stack[-1].setdefault("counts", {})
            counts[name] = counts.get(name, 0) + n


def start() -> None:
    """Begin keeping records (the ones kept before are dropped)."""
    global _started, _offset, _counters0
    with _lock:
        _records.clear()
        _offset = time.time_ns() - time.monotonic_ns()
        _counters0 = dict(_counters)
        _started = True


def stop() -> Tuple[List[dict], Dict[str, int]]:
    """Stop keeping records; return them and each counter's growth since
    :func:`start`."""
    global _started
    with _lock:
        _started = False
        recs = list(_records)
        _records.clear()
        grown = {k: v - _counters0.get(k, 0) for k, v in _counters.items()
                 if v != _counters0.get(k, 0)}
    return recs, grown


def records() -> List[dict]:
    """The records kept so far, left in place."""
    with _lock:
        return list(_records)


def totals() -> Dict[str, float]:
    """Each span name's summed wall seconds in this process."""
    with _lock:
        return {k: v / 1e9 for k, v in _totals.items()}


def counters() -> Dict[str, int]:
    """Each counter's value in this process."""
    with _lock:
        return dict(_counters)
