"""Klammer-style retention-time prediction by linear regression.

Reference: crates/sage/src/ml/retention_model.rs — 69 features = AA
counts + N-terminal (positions 0,1) and C-terminal (positions len-3,
len-2) one-hots over the 22 valid AAs, peptide length, ln1p(mass), and
an intercept. Trained on confident target PSMs (q <= 0.01), predictions
clamped to [0, 1]; ``delta_rt_model = |aligned_rt - predicted|``.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from ..chem.mass import VALID_AA
from ..index.builder import IndexedDatabase
from ..ops.features import FeatureTable
from .regression import LinearRegression

N_AA = len(VALID_AA)  # 22
FEATURES = N_AA * 3 + 3
N_TERMINAL = N_AA
C_TERMINAL = N_AA * 2
PEPTIDE_LEN = FEATURES - 3
PEPTIDE_MASS = FEATURES - 2
INTERCEPT = FEATURES - 1

# map[ascii - ord('A')] -> index into VALID_AA
AA_MAP = np.zeros(26, dtype=np.int64)
for _i, _aa in enumerate(VALID_AA):
    AA_MAP[_aa - ord("A")] = _i


def embed_batch(db: IndexedDatabase, pep_idx: np.ndarray) -> np.ndarray:
    """Vectorized RetentionModel::embed (retention_model.rs:42-59) for a
    batch of peptide indices, from the columnar residue table."""
    t = db.table
    pep_idx = np.asarray(pep_idx, dtype=np.int64)
    res = t.residues[pep_idx]  # u8 [n, L]
    lens = t.lens[pep_idx].astype(np.int64)
    n, L = res.shape
    X = np.zeros((n, FEATURES), dtype=np.float64)

    valid = np.arange(L)[None, :] < lens[:, None]
    aa = AA_MAP[np.clip(res.astype(np.int64) - 65, 0, 25)]

    rows = np.broadcast_to(np.arange(n)[:, None], (n, L))
    # AA counts
    np.add.at(X, (rows[valid], aa[valid]), 1.0)
    # N-terminal: positions 0 and 1
    pos = np.broadcast_to(np.arange(L)[None, :], (n, L))
    ntm = valid & (pos <= 1)
    np.add.at(X, (rows[ntm], N_TERMINAL + aa[ntm]), 1.0)
    # C-terminal: positions cterm and cterm+1 where cterm = len - 3
    # (saturating at 0). The reference's match arms test 0|1 first, so a
    # position that is both N- and C-terminal only counts as N-terminal.
    cterm = np.maximum(lens - 3, 0)
    ctm = valid & (pos > 1) & ((pos == cterm[:, None]) | (pos == cterm[:, None] + 1))
    np.add.at(X, (rows[ctm], C_TERMINAL + aa[ctm]), 1.0)

    X[:, PEPTIDE_LEN] = lens
    X[:, PEPTIDE_MASS] = np.log1p(t.mono[pep_idx].astype(np.float64))
    X[:, INTERCEPT] = 1.0
    return X


def predict(db: IndexedDatabase, t: FeatureTable) -> Optional[bool]:
    """retention_model.rs:14-27: fit on confident targets, write
    ``predicted_rt`` (clamped [0,1]) and ``delta_rt_model`` columns."""
    c = t.columns
    train = (c["label"] == 1) & (c["spectrum_q"] <= 0.01)
    if not train.any():
        return None
    Xt = embed_batch(db, c["peptide_idx"][train])
    lr = LinearRegression.fit(Xt, c["aligned_rt"][train].astype(np.float64))
    if lr is None:
        return None
    X = embed_batch(db, c["peptide_idx"])
    pred = np.clip(lr.predict(X), 0.0, 1.0).astype(np.float32)
    c["predicted_rt"][:] = pred
    c["delta_rt_model"][:] = np.abs(c["aligned_rt"] - pred).astype(np.float32)
    return True
