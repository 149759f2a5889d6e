"""Median over the window's batches of a batch's time in the program's
``search.fetch`` spans (ms): the host waiting on the card for a
device-to-host copy."""

import importlib


def read(facts, cell):
    ps = importlib.import_module("benchmark.program_spans")
    return ps.batch_ms(facts, "search.fetch")
