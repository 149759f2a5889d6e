"""IDPicker-style protein grouping via bipartite set cover.

Reference: crates/sage/src/protein_grouping.rs — peptides collapse into
meta-peptides (identical protein sets), proteins with identical evidence
collapse into groups, then a greedy cover: degree-1 peptides force their
protein group into the cover; remaining rounds pick the group with the
largest remaining degree (ties by original degree). Run first over
confident peptides (peptide_q < threshold), then over all peptides;
features still unannotated fall back to their raw protein list.
"""

from __future__ import annotations

import logging
from typing import Dict, List, Optional, Tuple

import numpy as np

from .index.builder import IndexedDatabase
from .ops.features import FeatureTable

log = logging.getLogger("sage_tpu_torch")


class BipartiteGraph:
    """protein_grouping.rs:60-156."""

    def __init__(self, edges: List[Tuple[int, int]], left_count: int, right_count: int):
        self.edges = list(edges)
        self.left_degree = [0] * left_count
        self.right_degree = [0] * right_count
        for l, r in self.edges:
            self.left_degree[l] += 1
            self.right_degree[r] += 1
        self.original_degree = list(self.left_degree)
        self.left_cover = [False] * left_count
        self.right_cover = [False] * right_count

    def trim(self) -> None:
        prev = -1
        while prev != len(self.edges):
            prev = len(self.edges)
            for l, r in self.edges:
                if self.right_degree[r] == 1:
                    self.left_cover[l] = True
            kept = []
            for l, r in self.edges:
                if self.left_cover[l]:
                    self.right_cover[r] = True
                    self.left_degree[l] -= 1
                    self.right_degree[r] -= 1
                else:
                    kept.append((l, r))
            self.edges = kept
            kept = []
            for l, r in self.edges:
                if self.right_cover[r]:
                    self.left_degree[l] -= 1
                    self.right_degree[r] -= 1
                else:
                    kept.append((l, r))
            self.edges = kept

    def add_largest_to_cover(self) -> None:
        best = None
        for i, (rem, orig) in enumerate(zip(self.left_degree, self.original_degree)):
            # max_by_key keeps the LAST max in Rust
            if best is None or (rem, orig) >= best[1]:
                best = (i, (rem, orig))
        if best is not None:
            self.left_cover[best[0]] = True

    def into_cover(self) -> List[bool]:
        while self.edges:
            self.trim()
            if self.edges:
                self.add_largest_to_cover()
        return self.left_cover


class _Lookup:
    def __init__(self, groups, proteins, protein_to_groups):
        self.groups = groups  # List[List[int]] of protein ixs
        self.proteins = proteins  # List[(name, decoy)]
        self.protein_to_groups = protein_to_groups  # {(name, decoy): [gix]}

    def _fmt_protein(self, ix: int, decoy_tag: str, generate_decoys: bool) -> str:
        name, decoy = self.proteins[ix]
        return f"{decoy_tag}{name}" if (decoy and generate_decoys) else name

    def _fmt_group(self, g: List[int], decoy_tag: str, generate_decoys: bool) -> str:
        return "/".join(
            sorted(self._fmt_protein(ix, decoy_tag, generate_decoys) for ix in g)
        )

    def group_string(self, peptide, db: IndexedDatabase) -> Optional[str]:
        gset = set()
        for name in peptide.proteins:
            for gi in self.protein_to_groups.get((name, peptide.decoy), ()):
                gset.add(gi)
        if not gset:
            return None
        return ";".join(
            sorted(
                self._fmt_group(self.groups[gi], db.decoy_tag, db.generate_decoys)
                for gi in gset
            )
        )


def _build_lookup(db: IndexedDatabase, peptide_ixs: List[int]) -> _Lookup:
    """ProteinGrouper::build + into_group_map
    (protein_grouping.rs:171-266)."""
    protein_index: Dict[Tuple[str, bool], int] = {}
    meta_set = set()
    for pix in sorted(peptide_ixs):
        peptide = db.peptides[pix]
        meta = []
        for name in peptide.proteins:
            key = (name, peptide.decoy)
            if key not in protein_index:
                protein_index[key] = len(protein_index)
            meta.append(protein_index[key])
        meta_set.add(tuple(sorted(meta)))

    log.info("-  found %d meta peptides", len(meta_set))

    prot_to_metapeps: Dict[int, List[int]] = {}
    for i, meta in enumerate(sorted(meta_set)):
        for p in meta:
            prot_to_metapeps.setdefault(p, []).append(i)

    evidence_to_group: Dict[Tuple[int, ...], List[int]] = {}
    for prot_ix, metas in prot_to_metapeps.items():
        evidence_to_group.setdefault(tuple(metas), []).append(prot_ix)

    groups: List[List[int]] = []
    edges: List[Tuple[int, int]] = []
    for gi, (metas, group) in enumerate(sorted(evidence_to_group.items())):
        groups.append(group)
        for m in metas:
            edges.append((gi, m))

    log.info("-  found %d protein groups", len(groups))

    cover = BipartiteGraph(edges, len(groups), len(meta_set)).into_cover()
    proteins = [None] * len(protein_index)
    for key, ix in protein_index.items():
        proteins[ix] = key
    protein_to_groups: Dict[Tuple[str, bool], List[int]] = {}
    for i, in_cover in enumerate(cover):
        if not in_cover:
            continue
        for prot_ix in groups[i]:
            protein_to_groups.setdefault(proteins[prot_ix], []).append(i)
    return _Lookup(groups, proteins, protein_to_groups)


def _annotate(t: FeatureTable, db: IndexedDatabase, threshold: Optional[float]) -> None:
    thr = min(max(threshold if threshold is not None else 1.0, 0.0), 1.0)
    c = t.columns
    sel = (c["label"] != -1) & (c["peptide_q"] < thr)
    peptide_ixs = sorted(set(int(p) for p in c["peptide_idx"][sel]))
    lookup = _build_lookup(db, peptide_ixs)

    cache: Dict[int, Optional[str]] = {}
    for i in range(len(t)):
        if t.protein_groups[i] is not None:
            continue
        pix = int(c["peptide_idx"][i])
        if pix not in cache:
            cache[pix] = lookup.group_string(db.peptides[pix], db)
        gs = cache[pix]
        if gs is not None:
            t.protein_groups[i] = gs
            c["num_protein_groups"][i] = gs.count(";") + 1


def generate_protein_groups(
    db: IndexedDatabase,
    t: FeatureTable,
    protein_grouping: bool,
    confident_peptide_threshold: Optional[float],
) -> None:
    """protein_grouping.rs:312-339."""
    if protein_grouping:
        if confident_peptide_threshold is not None:
            _annotate(t, db, confident_peptide_threshold)
        _annotate(t, db, None)

    c = t.columns
    cache: Dict[int, Tuple[str, int]] = {}
    for i in range(len(t)):
        if t.protein_groups[i] is not None:
            continue
        pix = int(c["peptide_idx"][i])
        if pix not in cache:
            pep = db.peptides[pix]
            cache[pix] = (
                pep.proteins_str(db.decoy_tag, db.generate_decoys),
                len(pep.proteins),
            )
        s, n = cache[pix]
        t.protein_groups[i] = s
        c["num_protein_groups"][i] = n
