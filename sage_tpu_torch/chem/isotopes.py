"""Theoretical isotopic distributions (first 3 peaks).

Reference: crates/sage/src/isotopes.rs — Poisson models for C13
(lambda = 0.011/carbon) and S33/S35, combined by 4-term convolution and
normalized to the maximum.
"""

from __future__ import annotations

import numpy as np

F32 = np.float32


def _convolve4(a, b):
    return [
        F32(a[0] * b[0]),
        F32(F32(a[0] * b[1]) + F32(a[1] * b[0])),
        F32(F32(F32(a[0] * b[2]) + F32(a[1] * b[1])) + F32(a[2] * b[0])),
        F32(
            F32(F32(F32(a[0] * b[3]) + F32(a[1] * b[2])) + F32(a[2] * b[1]))
            + F32(a[3] * b[0])
        ),
    ]


_FACT = [1.0, 1.0, 2.0, 6.0]


def _carbon_isotopes(count: int):
    lam = F32(count) * F32(0.011)
    return [F32(lam**k * np.exp(-lam) / F32(_FACT[k])) for k in range(4)]


def _sulfur_isotopes(count: int):
    lam33 = F32(count) * F32(0.0076)
    lam35 = F32(count) * F32(0.044)
    s35 = [
        F32(np.exp(-lam35)),
        F32(0.0),
        F32(lam35 * np.exp(-lam35)),
        F32(0.0),
    ]
    s33 = [F32(lam33**k * np.exp(-lam33) / F32(_FACT[k])) for k in range(4)]
    return _convolve4(s33, s35)


def peptide_isotopes(carbons: int, sulfurs: int) -> np.ndarray:
    """First three relative isotope abundances, normalized to the max
    (isotopes.rs:43-50)."""
    c = _carbon_isotopes(carbons)
    s = _sulfur_isotopes(sulfurs)
    conv = _convolve4(c, s)
    mx = max(conv[0], conv[1], conv[2])
    return np.array([conv[0] / mx, conv[1] / mx, conv[2] / mx], dtype=np.float32)
