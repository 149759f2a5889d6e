"""OLS linear regression: beta = (X^T X)^-1 X^T y via the normal equations
and the Gauss-Jordan solver (reference crates/sage/src/ml/regression.rs).

The reference accumulates X^T X with a nondeterministic rayon reduction,
so matmul accumulation order is free; the solve path (including eps*I
regularization retries) matches gauss.rs exactly.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

from .gauss import solve


@dataclasses.dataclass
class LinearRegression:
    beta: np.ndarray  # f64 [D]
    r2: float

    @staticmethod
    def fit(X: np.ndarray, y: np.ndarray) -> Optional["LinearRegression"]:
        X = np.asarray(X, dtype=np.float64)
        y = np.asarray(y, dtype=np.float64)
        n = X.shape[0]
        if n == 0:
            return None
        cov = X.T @ X
        b = X.T @ y
        beta = solve(cov, b)
        if beta is None:
            return None
        beta = beta[:, 0]
        y_mean = y.sum() / n
        y_var = (y * y).sum() - n * y_mean * y_mean
        sse = float(((X @ beta - y) ** 2).sum())
        with np.errstate(divide="ignore", invalid="ignore"):
            r2 = float(1.0 - sse / y_var)
        return LinearRegression(beta=beta, r2=r2)

    def predict(self, X: np.ndarray) -> np.ndarray:
        return np.asarray(X, dtype=np.float64) @ self.beta
