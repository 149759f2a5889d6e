"""Seconds of the database build's digest: the program's ``db.digest``
span (enzyme digest, modifications, decoys, mass sort)."""

import importlib


def read(facts, cell):
    ps = importlib.import_module("benchmark.program_spans")
    return ps.build_s(facts, "db.digest")
