"""Seconds of the database build's fragment step: the program's
``db.fragments`` span (the peptide table and its ion fragments)."""

import importlib


def read(facts, cell):
    ps = importlib.import_module("benchmark.program_spans")
    return ps.build_s(facts, "db.fragments")
