"""Median over the window's batches of a batch's self time in the
program's ``search.prep`` span (ms): padding the peaks, the packed
peaks' upload call and the query rows' expansion, less the uploads."""

import importlib


def read(facts, cell):
    ps = importlib.import_module("benchmark.program_spans")
    return ps.batch_ms(facts, "search.prep", self_time=True)
