"""The work a search's inputs need, and the H100's peaks.

A roofline share is the least time one H100 could take for the work,
the larger of the operations over the peak rate and the bytes over the
memory bandwidth, divided by the device time the search took. The work
is counted here from the spectra, the candidates each precursor window
holds (the benchmark's own digestion of the proteome) and the
tolerances: never from a kernel's layout (tile sizes, padded peaks,
padded rows), so that it stays the same whatever implements the search.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np

from .proteome import NEUTRON, Enzyme, Mods, PROTON, peptide_masses

# NVIDIA H100 SXM data sheet (the on-chip guide): f32 outside the tensor
# cores, and HBM3 bandwidth
PEAK_F32_OPS = 67e12
PEAK_BYTES = 3.35e12


class Candidates:
    """Every peptide of the proteome (targets; each decoy has its
    target's mass) by ascending mass, with prefix sums of the ion slots
    the fragment index stores for them."""

    def __init__(self, proteins, sage_cfg: dict):
        db = sage_cfg["database"]
        self.mass, lens = peptide_masses(
            proteins, Enzyme(db.get("enzyme") or {}), Mods(db),
            float(db.get("peptide_min_mass") or 500.0),
            float(db.get("peptide_max_mass") or 5000.0))
        skip = int(db.get("min_ion_index", 2))
        # b and y ions k < len - 1, less the first ``skip`` of each series
        slots = 2 * np.maximum(lens.astype(np.int64) - 1 - skip, 0)
        self.slot_sum = np.r_[0, np.cumsum(slots)]
        self.full_sum = np.r_[0, np.cumsum(2 * np.maximum(lens - 1, 0))]


def narrow_work(cands: Candidates, spectra: Sequence, prec_tol,
                max_frag_charge, peaks_of, isotopes: Sequence[int] = (0,)) -> dict:
    """Operations and bytes a narrow search of ``spectra`` needs: each
    candidate in one of a spectrum's precursor windows (one window per
    searched isotope error, around the precursor mass less that many
    neutrons; targets and decoys) is decided once, at one compare for
    each of its stored ion slots and fragment charges and one for each of
    the spectrum's finite peaks;
    the peaks (mass and intensity, f32) and each window's candidates'
    ion slots (f32) are read once, and one PSM record (64 bytes) is
    written a spectrum. ``peaks_of(s)`` gives a spectrum's finite peak
    count."""
    kind, lo, hi = prec_tol
    ops = 0.0
    nbytes = 0.0
    starts, ends = [], []
    for s in spectra:
        pm = (np.float32(s.prec_mz) - PROTON) * np.float32(s.charge)
        cap = (max_frag_charge + 1) if max_frag_charge is not None else s.charge
        nz = max(min(s.charge, cap), 2) - 1
        p = peaks_of(s)
        nbytes += 8.0 * p + 64.0
        for iso in isotopes:
            m = float(np.float32(pm - np.float32(np.float32(iso) * NEUTRON)))
            if kind == "ppm":
                a, b = m + m * lo / 1e6, m + m * hi / 1e6
            else:
                a, b = m + lo, m + hi
            i = int(np.searchsorted(cands.mass, a, "left"))
            j = int(np.searchsorted(cands.mass, b, "right"))
            n_c = 2 * (j - i)
            slots = 2 * float(cands.slot_sum[j] - cands.slot_sum[i])
            ops += slots * nz + n_c * p
            starts.append(i)
            ends.append(j)
    # each candidate row any window holds is read once
    if starts:
        order = np.argsort(starts)
        cur_a, cur_b = -1, -1
        for k in order:
            a, b = starts[k], ends[k]
            if a > cur_b:
                if cur_b > cur_a:
                    nbytes += 2 * 4.0 * float(cands.full_sum[cur_b] - cands.full_sum[cur_a])
                cur_a, cur_b = a, b
            else:
                cur_b = max(cur_b, b)
        if cur_b > cur_a:
            nbytes += 2 * 4.0 * float(cands.full_sum[cur_b] - cands.full_sum[cur_a])
    return {"ops": ops, "bytes": nbytes}


def least_seconds(work: dict) -> tuple:
    """(seconds, which bound sets it) for one H100."""
    t_ops = work["ops"] / PEAK_F32_OPS
    t_bytes = work["bytes"] / PEAK_BYTES
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")
