"""Spans, the device trace and their reduction to per-layer numbers.

The benchmark records host spans (name, start, end in ``time.time_ns``
nanoseconds) around its calls into the program. In a traced run the
window runs under ``torch.profiler`` with CUDA activity; the device
operations' intervals (on the same clock) give the busy time, the time
by operation name and the idle gaps, each gap named by the innermost
benchmark span open at its middle.
"""

from __future__ import annotations

import time
from contextlib import contextmanager
from typing import Dict, List, Optional, Tuple


class Spans:
    """Host spans in memory: ``{name: [(start_ns, end_ns), ...]}``."""

    def __init__(self):
        self.by_name: Dict[str, List[Tuple[int, int]]] = {}

    def add(self, name: str, t0: int, t1: int) -> None:
        self.by_name.setdefault(name, []).append((t0, t1))

    @contextmanager
    def span(self, name: str):
        t0 = time.time_ns()
        try:
            yield
        finally:
            self.add(name, t0, time.time_ns())

    def seconds(self, name: str) -> List[float]:
        return [(b - a) / 1e9 for a, b in self.by_name.get(name, [])]

    def label_at(self, t: int) -> str:
        """The shortest span open at ``t`` (the innermost), or "none"."""
        best, width = "none", None
        for name, items in self.by_name.items():
            for a, b in items:
                if a <= t <= b and (width is None or b - a < width):
                    best, width = name, b - a
        return best


def device_intervals(prof) -> List[Tuple[str, int, int]]:
    """(name, start_ns, end_ns) of every device operation a profile
    recorded (kernels, copies, sets)."""
    from torch.autograd import DeviceType

    out = []
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == DeviceType.CUDA:
            s = int(e.start_ns())
            out.append((e.name(), s, s + int(e.duration_ns())))
    return out


def reduce(ops: List[Tuple[str, int, int]], t0: int, t1: int,
           spans: Optional[Spans] = None, top: int = 10) -> dict:
    """Busy seconds (the union of the operations' intervals inside the
    window [t0, t1]), the window's seconds, the device seconds by
    operation name, and the longest idle gaps named by the host span open
    at their middle."""
    clipped = sorted((max(a, t0), min(b, t1), n) for n, a, b in ops
                     if b > t0 and a < t1)
    busy = 0
    merged: List[List[int]] = []
    by_name: Dict[str, float] = {}
    for a, b, n in clipped:
        by_name[n] = by_name.get(n, 0.0) + (b - a) / 1e9
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    busy = sum(b - a for a, b in merged)
    gaps = []
    edges = [t0] + [x for ab in merged for x in ab] + [t1]
    for i in range(0, len(edges), 2):
        a, b = edges[i], edges[i + 1]
        if b > a:
            label = spans.label_at((a + b) // 2) if spans else "none"
            gaps.append((label, (b - a) / 1e9))
    gaps.sort(key=lambda g: -g[1])
    ops_top = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
    return {
        "busy_s": busy / 1e9,
        "window_s": (t1 - t0) / 1e9,
        "device_s": sum(by_name.values()),
        "by_name": by_name,
        "device_ops": [[n[:120], s] for n, s in ops_top],
        "idle_gaps": [[n, s] for n, s in gaps[:top]],
        "n_ops": len(clipped),
    }
