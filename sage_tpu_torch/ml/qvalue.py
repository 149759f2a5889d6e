"""Classic target-decoy q-values (reference crates/sage/src/ml/qvalue.rs).

Operates on arrays: the caller sorts by score descending; q =
(1 + #decoys) / #targets cumulatively, then reverse cumulative minimum.
"""

from __future__ import annotations

import numpy as np


def spectrum_q_value(labels_sorted_desc: np.ndarray) -> tuple:
    """q-values for PSMs already sorted by score descending.

    labels: +1 target / -1 decoy. Returns (q [f32], n_passing at 1% —
    counting every PSM, matching qvalue.rs:8-36)."""
    decoy = labels_sorted_desc == -1
    d = 1.0 + np.cumsum(decoy, dtype=np.float64)
    t = np.cumsum(~decoy, dtype=np.float64)
    with np.errstate(divide="ignore", invalid="ignore"):
        q = (d.astype(np.float32) / t.astype(np.float32)).astype(np.float32)
    q = reverse_cummin(q)
    passing = int(np.sum(q <= 0.01))
    return q, passing


def reverse_cummin(q: np.ndarray) -> np.ndarray:
    """Reverse cumulative minimum with initial 1.0, using Rust f32::min
    NaN semantics (min(1.0, NaN) == 1.0 — NaN never propagates)."""
    rev = np.r_[np.float32(1.0), q[::-1]]
    return np.fmin.accumulate(rev)[1:][::-1].astype(np.float32)
