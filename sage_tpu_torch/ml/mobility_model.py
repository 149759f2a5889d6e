"""Ion-mobility (1/K0) prediction by linear regression.

Reference: crates/sage/src/ml/mobility_model.rs — 100 features = AA
counts, percent composition, N-/C-terminal one-hots (22 AA x 4), six
physicochemical class counts, charge, 1/charge, m/z, length, mass/1000,
intercept. Predictions clamped to [0, 2];
``delta_ims_model = |ims - predicted|``.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from ..chem.mass import VALID_AA
from ..index.builder import IndexedDatabase
from ..ops.features import FeatureTable
from .regression import LinearRegression
from .retention_model import AA_MAP

N_AA = len(VALID_AA)  # 22
FEATURES = N_AA * 4 + 12
PCT_START = N_AA
N_TERMINAL = N_AA * 2
C_TERMINAL = N_AA * 3
NUM_BRANCHED = FEATURES - 12
NUM_TINY = FEATURES - 11
NUM_UC_POLAR = FEATURES - 10
NUM_BULKY = FEATURES - 9
NUM_POSITIVE = FEATURES - 8
NUM_NEGATIVE = FEATURES - 7
INV_PEPTIDE_CHARGE = FEATURES - 6
PEPTIDE_CHARGE = FEATURES - 5
PEPTIDE_MZ = FEATURES - 4
PEPTIDE_LEN = FEATURES - 3
PEPTIDE_MASS = FEATURES - 2
INTERCEPT = FEATURES - 1


def _cls(aas: str) -> np.ndarray:
    """Replicates a reference quirk: mobility_model.rs:42-77 defines the
    class sets as ASCII offsets (b'L' - b'A' = 11) but compares them
    against the VALID_AA *index* (`let x = idx` where idx = map[residue],
    mobility_model.rs:117-137). So e.g. "bulky" actually counts
    {N, O, K, G}, not {L, V, I, F, W, Y}. Parity requires keeping it."""
    m = np.zeros(N_AA, dtype=np.float64)
    for a in aas:
        ascii_off = ord(a) - 65
        if ascii_off < N_AA:
            m[ascii_off] = 1.0
    return m


BULKY = _cls("LVIFWY")
UC_POLAR = _cls("STNQ")
POSITIVE = _cls("RKH")
NEGATIVE = _cls("DE")
TINY = _cls("GAS")
BRANCHED = _cls("LIV")


def embed_batch(db: IndexedDatabase, pep_idx: np.ndarray, charge: np.ndarray) -> np.ndarray:
    """Vectorized MobilityModel::embed (mobility_model.rs:97-149)."""
    t = db.table
    pep_idx = np.asarray(pep_idx, dtype=np.int64)
    charge = np.asarray(charge, dtype=np.float64)
    res = t.residues[pep_idx]
    lens = t.lens[pep_idx].astype(np.int64)
    n, L = res.shape
    X = np.zeros((n, FEATURES), dtype=np.float64)

    valid = np.arange(L)[None, :] < lens[:, None]
    aa = AA_MAP[np.clip(res.astype(np.int64) - 65, 0, 25)]
    rows = np.broadcast_to(np.arange(n)[:, None], (n, L))
    pos = np.broadcast_to(np.arange(L)[None, :], (n, L))

    np.add.at(X, (rows[valid], aa[valid]), 1.0)
    ntm = valid & (pos <= 1)
    np.add.at(X, (rows[ntm], N_TERMINAL + aa[ntm]), 1.0)
    # C-terminal: x > cterm (the LAST TWO residues); 0|1 arm wins first
    cterm = np.maximum(lens - 3, 0)
    ctm = valid & (pos > 1) & (pos > cterm[:, None])
    np.add.at(X, (rows[ctm], C_TERMINAL + aa[ctm]), 1.0)

    counts = X[:, :N_AA]
    X[:, NUM_BULKY] = counts @ BULKY
    X[:, NUM_UC_POLAR] = counts @ UC_POLAR
    X[:, NUM_POSITIVE] = counts @ POSITIVE
    X[:, NUM_NEGATIVE] = counts @ NEGATIVE
    X[:, NUM_TINY] = counts @ TINY
    X[:, NUM_BRANCHED] = counts @ BRANCHED

    pl = lens.astype(np.float64)
    X[:, PCT_START : PCT_START + N_AA] = counts / pl[:, None]
    X[:, PEPTIDE_CHARGE] = charge
    X[:, INV_PEPTIDE_CHARGE] = 1.0 / charge
    X[:, PEPTIDE_LEN] = pl
    mono = t.mono[pep_idx].astype(np.float64)
    X[:, PEPTIDE_MASS] = mono / 1000.0
    X[:, PEPTIDE_MZ] = (mono / charge) / 1000.0
    X[:, INTERCEPT] = 1.0
    return X


def predict(db: IndexedDatabase, t: FeatureTable) -> Optional[bool]:
    """mobility_model.rs:14-33: fit on confident targets, write
    ``predicted_ims`` (clamped [0,2]) and ``delta_ims_model``."""
    c = t.columns
    train = (c["label"] == 1) & (c["spectrum_q"] <= 0.01)
    if not train.any():
        return None
    Xt = embed_batch(db, c["peptide_idx"][train], c["charge"][train])
    lr = LinearRegression.fit(Xt, c["ims"][train].astype(np.float64))
    if lr is None:
        return None
    X = embed_batch(db, c["peptide_idx"], c["charge"])
    pred = np.clip(lr.predict(X), 0.0, 2.0).astype(np.float32)
    c["predicted_ims"][:] = pred
    c["delta_ims_model"][:] = np.abs(c["ims"] - pred).astype(np.float32)
    return True
