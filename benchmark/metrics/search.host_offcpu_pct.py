"""Median over the window's batches of the share of the self time of the
program's ``search.prep``, ``search.dispatch`` and ``search.finalize``
spans in which the thread was off the CPU: 100 x (1 - thread CPU time /
wall time), waiting for the interpreter lock or the scheduler."""

import importlib


def read(facts, cell):
    ps = importlib.import_module("benchmark.program_spans")
    return ps.batch_offcpu_pct(
        facts, ("search.prep", "search.dispatch", "search.finalize"))
