"""Median over the window's batches of a batch's time in the program's
``search.upload`` spans (ms): every host-to-device copy of the batch."""

import importlib


def read(facts, cell):
    ps = importlib.import_module("benchmark.program_spans")
    return ps.batch_ms(facts, "search.upload")
