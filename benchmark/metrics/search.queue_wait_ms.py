"""Median over the window's batches of a batch's time in the program's
``search.wait`` spans (ms): queued between its stages for the other
thread, or behind other batches."""

import importlib


def read(facts, cell):
    ps = importlib.import_module("benchmark.program_spans")
    return ps.batch_ms(facts, "search.wait")
