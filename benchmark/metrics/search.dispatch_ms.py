"""Median over the window's batches of a batch's self time in the
program's ``search.dispatch`` spans (ms): the plan and the kernel
enqueues, less the uploads."""

import importlib


def read(facts, cell):
    ps = importlib.import_module("benchmark.program_spans")
    return ps.batch_ms(facts, "search.dispatch", self_time=True)
