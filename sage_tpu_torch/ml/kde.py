"""Kernel density estimation for posterior error probabilities.

Reference: crates/sage/src/ml/kde.rs — Gaussian KDE with a
Silverman-style bandwidth ``sigma * (4/3n)^0.2``, separate target/decoy
densities evaluated on ``bins`` evenly spaced scores, optional
monotonization (reverse cummax), and linear interpolation at query time.

The reference evaluates the N x bins kernel sum with a nondeterministic
rayon reduction, so there is no bit-exact order to preserve — we use
chunked vectorized numpy, which is at least as accurate.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import numpy as np


def _std(x: np.ndarray) -> float:
    m = float(np.mean(x)) if x.size else float("nan")
    return float(np.sqrt(np.sum((x - m) ** 2) / x.size)) if x.size else float("nan")


class Kde:
    """kde.rs:14-49."""

    def __init__(self, sample: np.ndarray, bw_adjust: Callable[[float], float]):
        self.sample = np.asarray(sample, dtype=np.float64)
        sigma = _std(self.sample)
        n = max(self.sample.size, 1)
        self.bandwidth = bw_adjust(sigma * (4.0 / 3.0 / n) ** 0.2)
        self.constant = np.sqrt(2.0 * np.pi) * self.bandwidth * self.sample.size

    def pdf(self, xs: np.ndarray) -> np.ndarray:
        """Vectorized density at each x (chunked over the sample axis)."""
        xs = np.asarray(xs, dtype=np.float64)
        out = np.zeros_like(xs)
        if self.sample.size == 0 or self.bandwidth == 0 or not np.isfinite(self.bandwidth):
            return out
        h = self.bandwidth
        chunk = max(1, int(4e6 // max(xs.size, 1)))
        for s in range(0, self.sample.size, chunk):
            blk = self.sample[s : s + chunk]
            z = (xs[:, None] - blk[None, :]) / h
            out += np.exp(-0.5 * z * z).sum(axis=1)
        return out / self.constant


@dataclasses.dataclass
class Estimator:
    """Binned PEP with linear interpolation (kde.rs:141-168)."""

    bins: np.ndarray  # f64 [B]
    min_score: float
    score_step: float

    def posterior_error(self, score) -> np.ndarray:
        score = np.asarray(score, dtype=np.float64)
        nb = self.bins.shape[0]
        with np.errstate(invalid="ignore", divide="ignore"):
            rel = (score - self.min_score) / self.score_step
        # Rust `as usize` saturates: NaN/negatives -> 0, +inf -> MAX
        with np.errstate(invalid="ignore"):
            fl = np.floor(rel)
        fl = np.where(np.isnan(fl), 0.0, fl)
        bin_lo = np.clip(fl, 0, nb - 1).astype(np.int64)
        bin_hi = np.minimum(nb - 1, bin_lo + 1)
        lower = self.bins[bin_lo]
        upper = self.bins[bin_hi]
        bin_lo_score = bin_lo * self.score_step + self.min_score
        with np.errstate(invalid="ignore", divide="ignore"):
            linear = (score - bin_lo_score) / self.score_step
        return lower + (upper - lower) * linear


def build_estimator(
    scores: np.ndarray,
    decoys: np.ndarray,
    monotonic: bool = True,
    bins: int = 1000,
    bw_adjust: Optional[Callable[[float], float]] = None,
) -> Estimator:
    """kde.rs:83-137: fit decoy/target KDEs, evaluate PEP on a linspace,
    optionally monotonize (reverse cummax)."""
    scores = np.asarray(scores, dtype=np.float64)
    decoys = np.asarray(decoys, dtype=bool)
    bw = bw_adjust if bw_adjust is not None else (lambda x: x)
    d = scores[decoys]
    t = scores[~decoys]
    pi = d.size / max(scores.size, 1)
    kd = Kde(d, bw)
    kt = Kde(t, bw)

    min_score = float(scores.min()) if scores.size else 0.0
    max_score = float(scores.max()) if scores.size else 1.0
    score_step = (max_score - min_score) / max(bins - 1, 1)

    xs = np.arange(bins, dtype=np.float64) * score_step + min_score
    dd = kd.pdf(xs) * pi
    tt = kt.pdf(xs) * (1.0 - pi)
    with np.errstate(invalid="ignore", divide="ignore"):
        pep = dd / (tt + dd)

    if monotonic:
        pep = np.maximum.accumulate(pep[::-1])[::-1]

    return Estimator(bins=pep, min_score=min_score, score_step=score_step)
