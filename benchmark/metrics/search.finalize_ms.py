"""Median over the window's batches of a batch's self time in the
program's ``search.finalize`` spans (ms): the host's unpacking, exact
rescoring and table, less the fetches."""

import importlib


def read(facts, cell):
    ps = importlib.import_module("benchmark.program_spans")
    return ps.batch_ms(facts, "search.finalize", self_time=True)
