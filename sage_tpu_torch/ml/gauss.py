"""Gauss-Jordan elimination with partial pivoting and eps*I regularization.

Exact behavioral port of the reference solver (reference
crates/sage/src/ml/gauss.rs:26-165): `solve` retries `solve_inner` with
eps = 1e-8, 1e-7, ..., 1.0 added to the diagonal until the left matrix
reduces to (a permutation-free) identity. The LDA scatter matrix is only
20x20 and the OLS normal matrices <=100x100, so a scalar host
implementation is exact and instant.
"""

from __future__ import annotations

from typing import Optional

import numpy as np


def _echelon(left: np.ndarray, right: np.ndarray) -> None:
    m, n = left.shape
    h = 0
    k = 0
    while h < m and k < n:
        # row with the largest value (not abs!) in pivot column, ties to
        # the last row — gauss.rs:92-98 uses `>=`
        max_i = 0
        max_v = -np.inf
        for i in range(h, m):
            if left[i, k] >= max_v:
                max_i, max_v = i, left[i, k]
        if left[max_i, k] == 0.0:
            k += 1
            continue
        if h != max_i:
            left[[h, max_i]] = left[[max_i, h]]
            right[[h, max_i]] = right[[max_i, h]]
        for i in range(h + 1, m):
            factor = left[i, k] / left[h, k]
            left[i, k] = 0.0
            left[i, k + 1 :] -= left[h, k + 1 :] * factor
            right[i, :] -= right[h, :] * factor
        h += 1
        k += 1


def _reduce(left: np.ndarray, right: np.ndarray) -> None:
    for i in range(left.shape[0] - 1, -1, -1):
        for j in range(left.shape[1]):
            x = left[i, j]
            if x == 0.0:
                continue
            left[i, j:] /= x
            right[i, :] /= x
            break


def _backfill(left: np.ndarray, right: np.ndarray) -> None:
    for i in range(left.shape[0] - 1, -1, -1):
        for j in range(left.shape[1]):
            if left[i, j] == 0.0:
                continue
            for k in range(i):
                factor = left[k, j] / left[i, j]
                left[k, :] -= left[i, :] * factor
                right[k, :] -= right[i, :] * factor
            break


def _left_solved(left: np.ndarray) -> bool:
    n = left.shape[1]
    for i in range(n):
        for j in range(n):
            x = left[i, j]
            if i == j:
                if x != 1.0 and x != 0.0:
                    return False
            elif x > 1e-8:
                return False
    return True


def solve_inner(left: np.ndarray, right: np.ndarray, eps: float) -> Optional[np.ndarray]:
    left = np.array(left, dtype=np.float64)
    right = np.array(right, dtype=np.float64)
    if right.ndim == 1:
        right = right[:, None]
    for i in range(left.shape[1]):
        left[i, i] += eps
    _echelon(left, right)
    _reduce(left, right)
    _backfill(left, right)
    return right if _left_solved(left) else None


def solve(left: np.ndarray, right: np.ndarray) -> Optional[np.ndarray]:
    """Solve left @ x = right, retrying with growing diagonal
    regularization (gauss.rs:42-51). Returns None if unsolvable."""
    eps = 1e-8
    while eps <= 1.0:
        out = solve_inner(left, right, eps)
        if out is not None:
            return out
        eps *= 10.0
    return None
