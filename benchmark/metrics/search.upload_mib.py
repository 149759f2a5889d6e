"""Median over the window's batches of the bytes the program counted into
``search.upload_bytes`` for a batch, in MiB."""

import importlib


def read(facts, cell):
    ps = importlib.import_module("benchmark.program_spans")
    v = ps.batch_count(facts, "search.upload_bytes")
    return None if v is None else v / float(1 << 20)
