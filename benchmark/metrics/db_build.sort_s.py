"""Seconds of the database build's sorts: the program's ``db.sort`` span
(the stable m/z sort of the fragments and each bucket's re-sort)."""

import importlib


def read(facts, cell):
    ps = importlib.import_module("benchmark.program_spans")
    return ps.build_s(facts, "db.sort")
