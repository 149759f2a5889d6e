"""Two-class linear discriminant analysis for PSM rescoring.

Reference: crates/sage/src/ml/linear_discriminant.rs. The 20-feature row
(FEATURE_NAMES, linear_discriminant.rs:19-41) is assembled as whole
columns from the FeatureTable; class means and within-class scatter are
plain f64 matmuls (the reference streams rows in parallel, so
accumulation order is already nondeterministic there); the solve
`Sw w = (mu_t - mu_d)` uses the exact Gauss-Jordan port. Scoring sets
``discriminant_score`` and the KDE-based ``posterior_error`` (log10,
floored at -324) per PSM.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from ..chem.mass import Tolerance
from ..ops.features import FeatureTable
from . import kde
from .gauss import solve

FEATURE_NAMES = [
    "rank",
    "charge",
    "ln1p(hyperscore)",
    "ln1p(delta_next)",
    "ln1p(delta_best)",
    "delta_mass_model",
    "isotope_error",
    "average_ppm",
    "ln1p(-poisson)",
    "ln1p(matched_intensity_pct)",
    "ln1p(matched_peaks)",
    "ln1p(longest_b)",
    "ln1p(longest_y)",
    "longest_y_pct",
    "ln1p(peptide_len)",
    "missed_cleavages",
    "rt",
    "ims",
    "sqrt(delta_rt_model)",
    "sqrt(delta_ims_model)",
]


class LinearDiscriminantAnalysis:
    """linear_discriminant.rs:54-131."""

    def __init__(self, coef: np.ndarray):
        self.coef = coef

    @staticmethod
    def train(X: np.ndarray, decoy: np.ndarray) -> Optional["LinearDiscriminantAnalysis"]:
        X = np.asarray(X, dtype=np.float64)
        decoy = np.asarray(decoy, dtype=bool)
        n_d = int(decoy.sum())
        n_t = int((~decoy).sum())
        if n_d == 0 or n_t == 0:
            return None
        mu_d = X[decoy].sum(axis=0) / n_d
        mu_t = X[~decoy].sum(axis=0) / n_t
        cd = X[decoy] - mu_d
        ct = X[~decoy] - mu_t
        sw = (cd.T @ cd) / n_d + (ct.T @ ct) / n_t
        coef = solve(sw, mu_t - mu_d)
        if coef is None:
            return None
        return LinearDiscriminantAnalysis(coef[:, 0])

    def score(self, X: np.ndarray) -> np.ndarray:
        return np.asarray(X, dtype=np.float64) @ self.coef


def _feature_matrix(t: FeatureTable, mass_pep: np.ndarray) -> np.ndarray:
    """The 20-column LDA design matrix (linear_discriminant.rs:162-193)."""
    c = t.columns
    n = len(t)
    X = np.empty((n, 20), dtype=np.float64)
    poisson = np.log1p(-c["poisson"])
    poisson = np.where(np.isfinite(poisson), poisson, 3.5)
    X[:, 0] = c["rank"]
    X[:, 1] = c["charge"]
    X[:, 2] = np.log1p(c["hyperscore"])
    X[:, 3] = np.log1p(c["delta_next"])
    X[:, 4] = np.log1p(c["delta_best"])
    X[:, 5] = mass_pep
    X[:, 6] = c["isotope_error"].astype(np.float64)
    X[:, 7] = c["average_ppm"].astype(np.float64)
    X[:, 8] = poisson
    X[:, 9] = np.log1p(c["matched_intensity_pct"].astype(np.float64))
    X[:, 10] = c["matched_peaks"]
    X[:, 11] = np.log1p(c["longest_b"].astype(np.float64))
    X[:, 12] = np.log1p(c["longest_y"].astype(np.float64))
    X[:, 13] = c["longest_y"].astype(np.float64) / c["peptide_len"].astype(np.float64)
    X[:, 14] = np.log1p(c["peptide_len"].astype(np.float64))
    X[:, 15] = c["missed_cleavages"]
    X[:, 16] = c["aligned_rt"].astype(np.float64)
    X[:, 17] = c["ims"].astype(np.float64)
    X[:, 18] = np.sqrt(np.clip(c["delta_rt_model"].astype(np.float64), 0.001, 0.999))
    X[:, 19] = np.sqrt(np.clip(c["delta_ims_model"].astype(np.float64), 0.001, 0.999))
    return X


def score_psms(t: FeatureTable, precursor_tol: Tolerance) -> Optional[bool]:
    """linear_discriminant.rs:133-231. Sets discriminant_score and
    posterior_error columns in place; returns None on fit failure (the
    caller falls back to the heuristic score)."""
    n = len(t)
    if n == 0:
        return None
    c = t.columns
    decoys = c["label"] == -1

    if precursor_tol.kind == "ppm":
        mass_error = c["delta_mass"].astype(np.float64)
        bw_adjust, bin_size = 2.0, max(precursor_tol.hi - precursor_tol.lo, 100.0)
    else:
        mass_error = (c["expmass"] - c["calcmass"]).astype(np.float64)
        bw_adjust, bin_size = 0.1, max(precursor_tol.hi - precursor_tol.lo, 1000.0)

    mass_model = kde.build_estimator(
        mass_error,
        decoys,
        monotonic=False,
        bins=int(abs(np.ceil(bin_size))),
        bw_adjust=lambda x: x * bw_adjust,
    )
    mass_pep = mass_model.posterior_error(mass_error)

    X = _feature_matrix(t, mass_pep)
    lda = LinearDiscriminantAnalysis.train(X, decoys)
    if lda is None or not np.all(np.isfinite(lda.coef)):
        return None
    disc = lda.score(X)

    pep_model = kde.build_estimator(disc, decoys, monotonic=True, bins=1000)
    with np.errstate(divide="ignore", invalid="ignore"):
        pep = np.log10(pep_model.posterior_error(disc))
    # Both fields are f32 in the reference Feature struct; keep the f32
    # rounding, then the -324 infinite floor (linear_discriminant.rs:218-228)
    c["discriminant_score"][:] = disc.astype(np.float32).astype(np.float64)
    pep32 = pep.astype(np.float32).astype(np.float64)
    c["posterior_error"][:] = np.where(np.isinf(pep32), -324.0, pep32)
    return True
