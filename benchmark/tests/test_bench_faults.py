"""The comparison has to fail: the control (the reference in the
program's place, one precision down) and each fault the cells can have,
planted under a run on the CPU at test size. A search serves answers
that can be checked one by one, so the faults are: half of a batch left
out, an answer altered where it is produced, and every PSM reported at
isotope error 0 (where the traffic reads a share of precursors at a
heavier isotope)."""

import numpy as np
import pytest

from _small import run_small

CELLS = ["tmt11-narrow.search", "tmt11-narrow.runner"]


def _root(cell, request):
    return (request.getfixturevalue("runner_root")
            if cell.endswith(".runner") else None)


def _run(cell, seed, request, **kw):
    root = _root(cell, request)
    return run_small(cell, seed, **({"root": root} if root else {}), **kw)


@pytest.mark.parametrize("cell", CELLS)
def test_sound_run_is_correct(cell, request):
    assert _run(cell, 77, request)["correct"]


@pytest.mark.parametrize("cell", CELLS)
def test_control_is_not_correct(cell, request):
    r = _run(cell, 77, request, control=True)
    assert not r["correct"], r["checks"]


def _drop_half(table):
    keep = np.flatnonzero(table.columns["spec_idx"] % 2 == 0)
    return table.select(keep)


def _wrong_isotope(table):
    c = dict(table.columns)
    c["isotope_error"] = np.zeros_like(c["isotope_error"])
    return type(table)(columns=c, spec_ids=table.spec_ids,
                       protein_groups=table.protein_groups,
                       fragments=table.fragments)


def _alter(table):
    c = table.columns
    c = dict(c)
    c["peptide_idx"] = c["peptide_idx"].copy()
    c["peptide_idx"][::3] += 1
    out = type(table)(columns=c, spec_ids=table.spec_ids,
                      protein_groups=table.protein_groups,
                      fragments=table.fragments)
    return out


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("fault", [_drop_half, _alter, _wrong_isotope])
def test_fault_is_not_correct(cell, fault, request):
    r = _run(cell, 78, request, fault=fault)
    assert not r["correct"], r["checks"]
