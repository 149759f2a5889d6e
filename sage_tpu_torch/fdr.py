"""Picked target-decoy competition FDR (Savitski / Lin).

Reference: crates/sage/src/fdr.rs. PSMs are grouped by a key (peptide
display string with decoys un-reversed; proteotypic protein string;
protein-group string); the max target and max decoy score survive per
group; a KDE fits the winners' scores; the decoy estimate is
``1 + cumulative sum of PEP`` (NOT the decoy count — fdr.rs:89-99);
q = decoys / targets with a reverse cumulative minimum. LFQ precursor
q-values use plain decoy counting at a 5% threshold (fdr.rs:228-287).
"""

from __future__ import annotations

from typing import Dict, Hashable, Optional, Tuple

import numpy as np

from .index.builder import IndexedDatabase
from .ml import kde
from .ml.qvalue import reverse_cummin
from .ops.features import FeatureTable

F32_MIN = np.float32(np.finfo(np.float32).min)


class Competition:
    __slots__ = ("forward", "forward_ix", "reverse", "reverse_ix")

    def __init__(self):
        self.forward = F32_MIN
        self.reverse = F32_MIN
        self.forward_ix: Optional[Hashable] = None
        self.reverse_ix: Optional[Hashable] = None

    def score(self) -> np.float32:
        return max(self.forward, self.reverse)

    def is_decoy(self) -> bool:
        return self.reverse >= self.forward


def assign_q_value(
    groups: Dict[Hashable, Competition], threshold: float
) -> Tuple[Dict[Hashable, np.float32], int]:
    """fdr.rs:59-120: KDE on group winners, decoy estimate = 1 + sum(PEP),
    reverse cummin; returns ({ix: q}, n passing targets)."""
    comps = list(groups.values())
    if not comps:
        return {}, 0
    winner_scores = np.array([float(c.score()) for c in comps], dtype=np.float64)
    winner_decoy = np.array([c.is_decoy() for c in comps], dtype=bool)
    estimator = kde.build_estimator(winner_scores, winner_decoy, monotonic=True)

    ixs = []
    decoys = []
    scores = []
    for c in comps:
        if c.forward_ix is not None:
            ixs.append(c.forward_ix)
            decoys.append(False)
            scores.append(np.float32(c.forward))
        if c.reverse_ix is not None:
            ixs.append(c.reverse_ix)
            decoys.append(True)
            scores.append(np.float32(c.reverse))
    scores = np.asarray(scores, dtype=np.float32)
    decoys = np.asarray(decoys, dtype=bool)
    order = np.argsort(-scores, kind="stable")
    scores = scores[order]
    decoys = decoys[order]
    pep = estimator.posterior_error(scores.astype(np.float64)).astype(np.float32)
    d = np.float32(1.0) + np.cumsum(pep, dtype=np.float32)
    t = np.cumsum(~decoys).astype(np.float32)
    with np.errstate(divide="ignore", invalid="ignore"):
        q = d / t
    q = reverse_cummin(q)
    passing = int(np.sum((q <= threshold) & ~decoys))
    out = {}
    for i, oi in enumerate(order):
        out[ixs[oi]] = q[i]
    return out, passing


def picked_peptide(db: IndexedDatabase, t: FeatureTable) -> int:
    """fdr.rs:123-153: group by peptide display string; decoys keyed by the
    re-reversed sequence iff the engine generated the decoys."""
    c = t.columns
    pep_idx = c["peptide_idx"]
    score = c["discriminant_score"].astype(np.float32)

    # Build keys once per unique peptide index
    uniq = np.unique(pep_idx)
    keys = {}
    is_decoy = {}
    for pi in uniq:
        peptide = db.peptides[int(pi)]
        if db.generate_decoys and peptide.decoy:
            keys[int(pi)] = str(peptide.reverse())
        else:
            keys[int(pi)] = str(peptide)
        is_decoy[int(pi)] = peptide.decoy

    groups: Dict[str, Competition] = {}
    for i in range(len(t)):
        pi = int(pep_idx[i])
        entry = groups.setdefault(keys[pi], Competition())
        if is_decoy[pi]:
            entry.reverse = max(entry.reverse, score[i])
            entry.reverse_ix = pi
        else:
            entry.forward = max(entry.forward, score[i])
            entry.forward_ix = pi

    scores, passing = assign_q_value(groups, 0.01)
    qcol = c["peptide_q"]
    for i in range(len(t)):
        q = scores.get(int(pep_idx[i]))
        if q is not None:
            qcol[i] = q
    return passing


def picked_protein(db: IndexedDatabase, t: FeatureTable) -> int:
    """fdr.rs:155-190: proteotypic peptides only (single parent protein);
    shared peptides keep protein_q = 1.0."""
    c = t.columns
    pep_idx = c["peptide_idx"]
    score = c["discriminant_score"].astype(np.float32)

    uniq = np.unique(pep_idx)
    proteo = {}
    pkey = {}
    pstr = {}
    is_decoy = {}
    for pi in uniq:
        peptide = db.peptides[int(pi)]
        proteo[int(pi)] = len(peptide.proteins) == 1
        pkey[int(pi)] = tuple(peptide.proteins)
        pstr[int(pi)] = peptide.proteins_str(db.decoy_tag, db.generate_decoys)
        is_decoy[int(pi)] = peptide.decoy

    groups: Dict[tuple, Competition] = {}
    for i in range(len(t)):
        pi = int(pep_idx[i])
        if not proteo[pi]:
            continue
        entry = groups.setdefault(pkey[pi], Competition())
        if is_decoy[pi]:
            entry.reverse = max(entry.reverse, score[i])
            entry.reverse_ix = pstr[pi]
        else:
            entry.forward = max(entry.forward, score[i])
            entry.forward_ix = pstr[pi]

    scores, passing = assign_q_value(groups, 0.01)
    qcol = c["protein_q"]
    for i in range(len(t)):
        pi = int(pep_idx[i])
        if proteo[pi]:
            q = scores.get(pstr[pi])
            if q is not None:
                qcol[i] = q
    return passing


def picked_protein_group(db: IndexedDatabase, t: FeatureTable) -> int:
    """fdr.rs:192-226: unique-group peptides only."""
    c = t.columns
    pep_idx = c["peptide_idx"]
    score = c["discriminant_score"].astype(np.float32)
    npg = c["num_protein_groups"]

    groups: Dict[str, Competition] = {}
    for i in range(len(t)):
        if npg[i] != 1 or t.protein_groups[i] is None:
            continue
        pg = t.protein_groups[i]
        entry = groups.setdefault(pg, Competition())
        if db.peptides[int(pep_idx[i])].decoy:
            entry.reverse = max(entry.reverse, score[i])
            entry.reverse_ix = pg
        else:
            entry.forward = max(entry.forward, score[i])
            entry.forward_ix = pg

    scores, passing = assign_q_value(groups, 0.01)
    qcol = c["protein_group_q"]
    for i in range(len(t)):
        if npg[i] != 1 or t.protein_groups[i] is None:
            continue
        q = scores.get(t.protein_groups[i])
        if q is not None:
            qcol[i] = q
    return passing


def picked_precursor(scores: np.ndarray, decoys: np.ndarray) -> Tuple[np.ndarray, int]:
    """fdr.rs:228-287: plain decoy-count q-values at a 5% threshold for
    LFQ precursor peaks. Returns (q per input row, n passing targets)."""
    scores = np.asarray(scores, dtype=np.float32)
    decoys = np.asarray(decoys, dtype=bool)
    order = np.argsort(-scores, kind="stable")
    dec = decoys[order]
    d = np.float32(1.0) + np.cumsum(dec).astype(np.float32)
    tgt = np.cumsum(~dec).astype(np.float32)
    with np.errstate(divide="ignore", invalid="ignore"):
        q = d / tgt
    q = reverse_cummin(q)
    passing = int(np.sum((q <= 0.05) & ~dec))
    out = np.empty_like(q)
    out[order] = q
    return out, passing
