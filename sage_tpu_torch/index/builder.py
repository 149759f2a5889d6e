"""Database build: FASTA -> mass-sorted peptide table + fragment index.

Reproduces the reference's build pipeline
(crates/sage/src/database.rs:162-364):

  digest -> group -> variable/static mods -> mass filter -> decoy
  generation -> target-collision drop -> sort by monoisotopic mass ->
  dedup-merge -> fragment generation -> m/z sort -> bucketing.

Outputs are columnar NumPy arrays designed to be uploaded to TPU HBM:
the peptide table (padded residue/mod matrices, masses, flags) feeds the
candidate-major scoring kernels, and the classic fragment-mass index
(fragment_mz, peptide_idx, bucket_min) feeds the peak-major open-search
path and parity tests.
"""

from __future__ import annotations

import dataclasses
import logging
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..chem.enzyme import EnzymeParameters, enzyme_parameters_from_config, group_digests
from ..chem.fasta import Fasta
from ..chem.mass import MONOISOTOPIC_MASSES
from ..chem.modification import (
    ModificationSpecificity,
    validate_mods,
    validate_var_mods,
)
from ..chem.peptide import Peptide
from ..native import seq_f32_cumsum_rows
from ..utils import trace

log = logging.getLogger("sage_tpu_torch")

F32 = np.float32

# Ion series kinds (ion_series.rs:6-15)
ION_KINDS = ("a", "b", "c", "x", "y", "z")
NTERM_KINDS = frozenset("abc")


def next_power_of_two(x: int) -> int:
    return 1 if x <= 1 else 1 << (x - 1).bit_length()


@dataclasses.dataclass
class DatabaseParams:
    """Fully-defaulted database build parameters (database.rs:95-120)."""

    bucket_size: int = 8192
    enzyme: Optional[dict] = None
    peptide_min_mass: float = 500.0
    peptide_max_mass: float = 5000.0
    ion_kinds: Tuple[str, ...] = ("b", "y")
    min_ion_index: int = 2
    static_mods: Dict[ModificationSpecificity, float] = dataclasses.field(default_factory=dict)
    variable_mods: Dict[ModificationSpecificity, List[float]] = dataclasses.field(
        default_factory=dict
    )
    max_variable_mods: int = 2
    decoy_tag: str = "rev_"
    generate_decoys: bool = True
    fasta: str = ""
    prefilter_chunk_size: int = 0
    prefilter: bool = False
    prefilter_low_memory: bool = True

    @staticmethod
    def from_config(cfg: dict) -> "DatabaseParams":
        return DatabaseParams(
            bucket_size=next_power_of_two(cfg.get("bucket_size") or 8192),
            enzyme=cfg.get("enzyme"),
            peptide_min_mass=cfg.get("peptide_min_mass") or 500.0,
            peptide_max_mass=cfg.get("peptide_max_mass") or 5000.0,
            ion_kinds=tuple(cfg.get("ion_kinds") or ("b", "y")),
            min_ion_index=cfg.get("min_ion_index", 2) if cfg.get("min_ion_index") is not None else 2,
            static_mods=validate_mods(cfg.get("static_mods")),
            variable_mods=validate_var_mods(cfg.get("variable_mods")),
            max_variable_mods=max(cfg.get("max_variable_mods") or 2, 1),
            decoy_tag=cfg.get("decoy_tag") or "rev_",
            generate_decoys=(
                cfg.get("generate_decoys") if cfg.get("generate_decoys") is not None else True
            ),
            fasta=cfg.get("fasta") or "",
            prefilter_chunk_size=cfg.get("prefilter_chunk_size") or 0,
            prefilter=bool(cfg.get("prefilter") or False),
            prefilter_low_memory=(
                cfg.get("prefilter_low_memory")
                if cfg.get("prefilter_low_memory") is not None
                else True
            ),
        )

    def enzyme_parameters(self) -> EnzymeParameters:
        return enzyme_parameters_from_config(self.enzyme)

    def auto_prefilter_chunk_size(self, fasta: Fasta) -> int:
        """database.rs:142-160: aim for ~2^23 modified peptides per chunk."""
        if self.prefilter_chunk_size:
            return self.prefilter_chunk_size
        MAX_PEPS_PER_CHUNK = 1 << 23
        enzyme = self.enzyme_parameters()
        total_unmodified = len(fasta.digest(enzyme))
        mod_count_estimate = (len(self.variable_mods) + 1) * (
            1 << self.max_variable_mods
        )
        chunk_count = mod_count_estimate * total_unmodified // MAX_PEPS_PER_CHUNK
        if chunk_count == 0:
            return max(len(fasta.targets), 1)
        return max(len(fasta.targets) // chunk_count, 1)

    # -- pipeline ---------------------------------------------------------

    def digest(self, fasta: Fasta) -> List[Peptide]:
        """database.rs:162-219."""
        enzyme = self.enzyme_parameters()
        digests = fasta.digest(enzyme)
        groups = group_digests(digests)
        log.debug("grouped %d digests into %d groups", len(digests), len(groups))

        mods = [(spec, m) for spec, masses in self.variable_mods.items() for m in masses]
        # Unmodified target digest sequences; decoys colliding with any target
        # sequence are dropped (database.rs:184-213).
        target_seqs = {g.reference.sequence for g in groups if not g.reference.decoy}

        lo, hi = F32(self.peptide_min_mass), F32(self.peptide_max_mass)
        # no mods configured: apply() would add a strict f32 zero to the
        # mass of every fresh (unmodified) peptide — exactly identity —
        # so the per-peptide modification pass is skipped wholesale
        # (~10% of a mod-free digest)
        no_mods = not mods and not self.static_mods
        # batch the sequential-f32 monoisotopic masses (same op order as
        # the scalar loop, via the native row cumsum — ~20% of a digest)
        monos, mono_ok = Peptide.batch_monoisotopic(
            [g.reference.sequence for g in groups]
        )
        out: List[Peptide] = []
        for gi, group in enumerate(groups):
            if not mono_ok[gi]:
                continue
            base = Peptide.from_group(group, _mono=monos[gi])
            if base is None:
                continue
            for peptide in (
                (base,) if no_mods
                else base.apply(mods, self.static_mods, self.max_variable_mods)
            ):
                if not (lo <= peptide.monoisotopic <= hi):
                    continue
                if self.generate_decoys:
                    candidates = (peptide.reverse(), peptide)
                else:
                    candidates = (peptide,)
                for p in candidates:
                    if p.decoy and p.sequence.decode("ascii") in target_seqs:
                        continue
                    out.append(p)

        reorder_peptides(out)
        return out

    def build(self, fasta: Fasta) -> "IndexedDatabase":
        """The whole build: a ``db.build`` span over ``db.digest``,
        ``db.fragments`` and ``db.sort``."""
        with trace.span("db.build"):
            with trace.span("db.digest"):
                peptides = self.digest(fasta)
            return self.build_from_peptides(peptides)

    def build_from_peptides(self, peptides: List[Peptide]) -> "IndexedDatabase":
        """database.rs:265-364 — generate ion-series fragments, filter by
        min_ion_index, sort by fragment m/z, bucket, and re-sort each bucket
        by peptide index (``db.fragments`` and ``db.sort`` spans)."""
        with trace.span("db.fragments"):
            table = PeptideTable.from_peptides(peptides)
            frag_mz, frag_pep = generate_index_fragments(
                table, self.ion_kinds, self.min_ion_index
            )

        with trace.span("db.sort"):
            order = np.argsort(frag_mz, kind="stable")
            frag_mz = frag_mz[order]
            frag_pep = frag_pep[order]
            # Flat m/z-sorted copies for the peak-major open-search path
            # (the bucketed arrays below are re-sorted by peptide per
            # bucket).
            frag_mz_flat = frag_mz.copy()
            frag_pep_flat = frag_pep.copy()

            n = frag_mz.shape[0]
            bucket_size = self.bucket_size
            n_buckets = (n + bucket_size - 1) // bucket_size
            bucket_min = np.empty(max(n_buckets, 0), dtype=np.float32)
            for b in range(n_buckets):
                sl = slice(b * bucket_size, min((b + 1) * bucket_size, n))
                bucket_min[b] = frag_mz[sl][0]
                inner = np.argsort(frag_pep[sl], kind="stable")
                frag_mz[sl] = frag_mz[sl][inner]
                frag_pep[sl] = frag_pep[sl][inner]

        potential_mods = [
            (spec, m) for spec, masses in self.variable_mods.items() for m in masses
        ]
        return IndexedDatabase(
            peptides=peptides,
            table=table,
            fragment_mz=frag_mz,
            fragment_pep=frag_pep,
            bucket_min=bucket_min,
            bucket_size=bucket_size,
            ion_kinds=tuple(self.ion_kinds),
            min_ion_index=self.min_ion_index,
            generate_decoys=self.generate_decoys,
            decoy_tag=self.decoy_tag,
            potential_mods=potential_mods,
            fragment_mz_flat=frag_mz_flat,
            fragment_pep_flat=frag_pep_flat,
        )


def reorder_peptides(peptides: List[Peptide]) -> None:
    """Sort by (monoisotopic, sequence, mods, nterm, cterm) and merge exact
    duplicates, keeping the first and OR-combining protein lists; a peptide
    that is a target in any source stays a target (database.rs:221-258)."""
    peptides.sort(key=Peptide.sort_key)
    # dedup keys computed once per peptide (the adjacent-pair compare
    # used to rebuild both tuples per step — ~15% of a large digest)
    keys = [p.dedup_key() for p in peptides]
    write = 0
    kw_prev = None
    for p, kp in zip(peptides, keys):
        if write > 0 and kw_prev == kp:
            keep = peptides[write - 1]
            # Concatenate protein lists (the reference extends keep with
            # remove's proteins, duplicates included — database.rs:239).
            keep.proteins = list(keep.proteins) + list(p.proteins)
            keep.decoy = keep.decoy and p.decoy
        else:
            peptides[write] = p
            kw_prev = kp
            write += 1
    del peptides[write:]
    for p in peptides:
        p.proteins = sorted(p.proteins)


@dataclasses.dataclass
class PeptideTable:
    """Columnar peptide table — the HBM-resident form of the database.

    residues : u8  [P, L]  ascii bytes, zero-padded
    mods     : f32 [P, L]  per-residue modification masses
    resmass  : f32 [P, L]  monoisotopic(residue) + mod (one f32 add each)
    lens     : i32 [P]
    nterm    : f32 [P]     N-term mod or 0.0 (``nterm.unwrap_or_default()``)
    cterm    : f32 [P]
    mono     : f32 [P]     full monoisotopic mass (ascending — sort key)
    decoy    : bool[P]
    """

    residues: np.ndarray
    mods: np.ndarray
    resmass: np.ndarray
    lens: np.ndarray
    nterm: np.ndarray
    cterm: np.ndarray
    mono: np.ndarray
    decoy: np.ndarray
    missed_cleavages: np.ndarray
    semi_enzymatic: np.ndarray
    position: np.ndarray
    max_len: int

    def __len__(self) -> int:
        return self.mono.shape[0]

    @staticmethod
    def from_peptides(peptides: Sequence[Peptide]) -> "PeptideTable":
        n = len(peptides)
        max_len = max((len(p.sequence) for p in peptides), default=1)
        residues = np.zeros((n, max_len), dtype=np.uint8)
        mods = np.zeros((n, max_len), dtype=np.float32)
        lens = np.zeros(n, dtype=np.int32)
        nterm = np.zeros(n, dtype=np.float32)
        cterm = np.zeros(n, dtype=np.float32)
        mono = np.zeros(n, dtype=np.float32)
        decoy = np.zeros(n, dtype=bool)
        mc = np.zeros(n, dtype=np.uint8)
        semi = np.zeros(n, dtype=bool)
        position = np.zeros(n, dtype=np.uint8)
        for i, p in enumerate(peptides):
            L = len(p.sequence)
            residues[i, :L] = np.frombuffer(p.sequence, dtype=np.uint8)
            if L:
                mods[i, :L] = p.modifications
            lens[i] = L
            nterm[i] = p.nterm if p.nterm is not None else 0.0
            cterm[i] = p.cterm if p.cterm is not None else 0.0
            mono[i] = p.monoisotopic
            decoy[i] = p.decoy
            mc[i] = p.missed_cleavages
            semi[i] = p.semi_enzymatic
            position[i] = int(p.position)
        return PeptideTable._assemble(
            residues, mods, lens, nterm, cterm, mono, decoy, mc, semi,
            position, max_len,
        )

    @staticmethod
    def _assemble(residues, mods, lens, nterm, cterm, mono, decoy, mc,
                  semi, position, max_len) -> "PeptideTable":
        # residue monoisotopic mass + mod, one f32 add per residue
        # (matches ion_series.rs:76: monoisotopic(r) + m)
        res_mono = np.where(
            (residues >= 65) & (residues <= 90),
            MONOISOTOPIC_MASSES[np.clip(residues.astype(np.int32) - 65, 0, 25)],
            np.float32(0.0),
        ).astype(np.float32)
        resmass = (res_mono + mods).astype(np.float32)
        return PeptideTable(
            residues=residues,
            mods=mods,
            resmass=resmass,
            lens=lens,
            nterm=nterm,
            cterm=cterm,
            mono=mono,
            decoy=decoy,
            missed_cleavages=mc,
            semi_enzymatic=semi,
            position=position,
            max_len=max_len,
        )

    @staticmethod
    def from_columns(
        seq_flat: bytes,
        seq_lens: np.ndarray,
        mods_flat: np.ndarray,
        nterm: np.ndarray,
        cterm: np.ndarray,
        mono: np.ndarray,
        decoy: np.ndarray,
        mc: np.ndarray,
        semi: np.ndarray,
        position: np.ndarray,
    ) -> "PeptideTable":
        """Vectorized table assembly straight from checkpoint columns —
        the same values ``from_peptides`` gathers object-by-object (NaN
        nterm/cterm means "no terminal mod" and lands as 0.0, exactly as
        from_peptides maps None). ~100x faster than materializing 1M
        Peptide objects first."""
        n = int(seq_lens.shape[0])
        max_len = int(seq_lens.max()) if n else 1
        lens = seq_lens.astype(np.int32, copy=False)
        valid = np.arange(max(max_len, 1), dtype=np.int32)[None, :] < lens[:, None]
        valid = valid[:, :max_len] if max_len else valid[:, :0]
        residues = np.zeros((n, max_len), dtype=np.uint8)
        residues[valid] = np.frombuffer(seq_flat, dtype=np.uint8)
        mods = np.zeros((n, max_len), dtype=np.float32)
        mods[valid] = mods_flat.astype(np.float32, copy=False)
        return PeptideTable._assemble(
            residues,
            mods,
            lens,
            np.nan_to_num(nterm, nan=0.0).astype(np.float32, copy=False),
            np.nan_to_num(cterm, nan=0.0).astype(np.float32, copy=False),
            mono.astype(np.float32, copy=False),
            decoy.astype(bool, copy=False),
            mc.astype(np.uint8),
            semi.astype(bool, copy=False),
            position.astype(np.uint8),
            max_len,
        )

    def ladders(self) -> Tuple[np.ndarray, np.ndarray]:
        """Sequential-f32 b/y cumulative ion ladders, [P, L] each padded with
        their final value. b[k] = nterm + sum(resmass[:k+1]);
        y[k] = (mono - nterm) - sum(resmass[:k+1]) (ion_series.rs:44-86).
        Only the first (len-1) entries are valid ions."""
        ion_lens = np.maximum(self.lens - 1, 0).astype(np.int32)
        b = seq_f32_cumsum_rows(self.resmass, self.nterm, ion_lens)
        y_init = (self.mono - self.nterm).astype(np.float32)
        y = seq_f32_cumsum_rows(-self.resmass, y_init, ion_lens)
        return b, y


def generate_index_fragments(
    table: PeptideTable, ion_kinds: Sequence[str], min_ion_index: int
) -> Tuple[np.ndarray, np.ndarray]:
    """All theoretical fragments that the reference stores in its index:
    per peptide, ions of each series except the first ``min_ion_index``
    ions from the relevant terminus (database.rs:272-297)."""
    P, L = table.resmass.shape
    n_ions = np.maximum(table.lens - 1, 0)
    ion_idx = np.arange(L, dtype=np.int32)[None, :]
    valid = ion_idx < n_ions[:, None]

    frags_mz: List[np.ndarray] = []
    frags_pep: List[np.ndarray] = []
    pep_ids = np.arange(P, dtype=np.uint32)[:, None]

    for kind in ion_kinds:
        ladder = _ion_ladder(table, kind)
        if kind in NTERM_KINDS:
            mask = valid & (ion_idx + 1 > min_ion_index)
        else:
            # (len - 1) - ion_idx > min_ion_index, with n_ions = len - 1
            mask = valid & ((n_ions[:, None] - ion_idx) > min_ion_index)
        frags_mz.append(ladder[mask])
        frags_pep.append(np.broadcast_to(pep_ids, (P, L))[mask])

    if not frags_mz:
        return np.zeros(0, dtype=np.float32), np.zeros(0, dtype=np.uint32)
    return (
        np.concatenate(frags_mz).astype(np.float32),
        np.concatenate(frags_pep).astype(np.uint32),
    )


def _ion_ladder(table: PeptideTable, kind: str) -> np.ndarray:
    """Cumulative neutral fragment masses for one ion series, sequential f32.

    Series seeds (ion_series.rs:44-53):
      a = nterm - (C+O); b = nterm; c = nterm + NH3
      x = mono - nterm + (C+O-NH3+N+H); y = mono - nterm; z = mono - nterm - NH3
    """
    C = F32(12.0)
    O = F32(15.994914)
    H = F32(1.007825)
    PRO = F32(1.0072764)
    N = F32(14.003074)
    NH3 = F32(N + F32(H * F32(2.0)) + PRO)

    ion_lens = np.maximum(table.lens - 1, 0).astype(np.int32)
    if kind in NTERM_KINDS:
        if kind == "a":
            init = (table.nterm - F32(C + O)).astype(np.float32)
        elif kind == "b":
            init = table.nterm.astype(np.float32)
        else:  # c
            init = (table.nterm + NH3).astype(np.float32)
        return seq_f32_cumsum_rows(table.resmass, init, ion_lens)
    base = (table.mono - table.nterm).astype(np.float32)
    if kind == "x":
        shift = F32(F32(F32(C + O) - NH3) + F32(N + H))
        init = (base + shift).astype(np.float32)
    elif kind == "y":
        init = base
    else:  # z
        init = (base - NH3).astype(np.float32)
    return seq_f32_cumsum_rows(-table.resmass, init, ion_lens)


@dataclasses.dataclass
class IndexedDatabase:
    """The built database: peptide objects (for output/display), the columnar
    table (for device kernels), and the bucketed fragment index."""

    peptides: List[Peptide]
    table: PeptideTable
    fragment_mz: np.ndarray  # f32 [N]
    fragment_pep: np.ndarray  # u32 [N]
    bucket_min: np.ndarray  # f32 [n_buckets]
    bucket_size: int
    ion_kinds: Tuple[str, ...]
    min_ion_index: int
    generate_decoys: bool
    decoy_tag: str
    potential_mods: List[Tuple[ModificationSpecificity, float]]
    # Flat m/z-sorted index (peak-major open-search path); None only for
    # checkpoints written before these fields existed.
    fragment_mz_flat: Optional[np.ndarray] = None
    fragment_pep_flat: Optional[np.ndarray] = None

    def __len__(self) -> int:
        return len(self.peptides)

    @property
    def num_fragments(self) -> int:
        return int(self.fragment_mz.shape[0])

    def peptide_window(self, lo: np.float32, hi: np.float32) -> Tuple[int, int]:
        """Indices [i0, i1) of peptides with monoisotopic mass in [lo, hi]
        — the precursor-window candidate range (database.rs:402-425 +
        the page_search edge-mass checks, which reduce to an exact
        mass-in-range test)."""
        mono = self.table.mono
        i0 = int(np.searchsorted(mono, lo, side="left"))
        i1 = int(np.searchsorted(mono, hi, side="right"))
        return i0, i1

    def query_fragments(
        self, pre_lo: float, pre_hi: float, frag_lo: float, frag_hi: float
    ) -> np.ndarray:
        """Reference-parity query over the bucketed index: indices of
        fragment entries within the fragment window whose parent peptide
        mass is in the precursor window (database.rs:480-536). Used by
        property tests and the peak-major search path."""
        lo_b, hi_b = binary_search_slice(self.bucket_min, frag_lo, frag_hi)
        i0, i1 = self.peptide_window(F32(pre_lo), F32(pre_hi))
        hits = []
        n = self.fragment_mz.shape[0]
        for b in range(lo_b, hi_b):
            s = b * self.bucket_size
            e = min(s + self.bucket_size, n)
            pep = self.fragment_pep[s:e]
            mz = self.fragment_mz[s:e]
            sel = (
                (pep >= i0)
                & (pep < i1)
                & (mz >= frag_lo)
                & (mz <= frag_hi)
            )
            hits.append(np.nonzero(sel)[0] + s)
        if not hits:
            return np.zeros(0, dtype=np.int64)
        return np.concatenate(hits)


def binary_search_slice(arr: np.ndarray, low, high) -> Tuple[int, int]:
    """Widest [left, right) covering every value in [low, high]
    (database.rs:549-561)."""
    left = max(int(np.searchsorted(arr, low, side="left")) - 1, 0)
    right = int(np.searchsorted(arr, high, side="right"))
    return left, max(right, left)


# ---------------------------------------------------------------------------
# Checkpoint / resume
# ---------------------------------------------------------------------------

CHECKPOINT_VERSION = 1


def save_database(db: IndexedDatabase, path: str) -> str:
    """Serialize a built database to one .npz checkpoint.

    The reference only has a debug dump (database.rs:435-458, never called
    by its runner); here checkpointing is a first-class feature — the
    index build is the natural restart unit for large-scale runs. All
    columnar arrays round-trip exactly (f32 bit patterns preserved);
    variable-length peptide metadata (mods, protein lists) is stored as
    flattened arrays + offsets."""
    import json as _json

    peps = db.peptides
    n = len(peps)
    seq_flat = b"".join(p.sequence for p in peps)
    seq_lens = np.array([len(p.sequence) for p in peps], dtype=np.int32)
    mods_flat = np.concatenate(
        [np.asarray(p.modifications, dtype=np.float32) for p in peps]
    ) if n else np.zeros(0, np.float32)
    nterm = np.array(
        [p.nterm if p.nterm is not None else np.nan for p in peps], np.float32
    )
    cterm = np.array(
        [p.cterm if p.cterm is not None else np.nan for p in peps], np.float32
    )
    prot_lists = [p.proteins for p in peps]
    prot_offsets = np.cumsum([0] + [len(x) for x in prot_lists]).astype(np.int64)
    prot_flat = "\x00".join(s for x in prot_lists for s in x)

    meta = {
        "version": CHECKPOINT_VERSION,
        "bucket_size": db.bucket_size,
        "ion_kinds": list(db.ion_kinds),
        "min_ion_index": db.min_ion_index,
        "generate_decoys": db.generate_decoys,
        "decoy_tag": db.decoy_tag,
        "potential_mods": [
            [str(spec), float(m)] for spec, m in db.potential_mods
        ],
    }
    np.savez_compressed(
        path,
        meta=np.frombuffer(_json.dumps(meta).encode(), dtype=np.uint8),
        seq_flat=np.frombuffer(seq_flat, dtype=np.uint8),
        seq_lens=seq_lens,
        mods_flat=mods_flat,
        nterm=nterm,
        cterm=cterm,
        mono=np.array([p.monoisotopic for p in peps], np.float32),
        decoy=np.array([p.decoy for p in peps], bool),
        missed_cleavages=np.array([p.missed_cleavages for p in peps], np.int32),
        semi=np.array([p.semi_enzymatic for p in peps], bool),
        position=np.array([int(p.position) for p in peps], np.int32),
        prot_offsets=prot_offsets,
        prot_flat=np.frombuffer(prot_flat.encode(), dtype=np.uint8),
        fragment_mz=db.fragment_mz,
        fragment_pep=db.fragment_pep,
        bucket_min=db.bucket_min,
    )
    return path


def load_database(path: str) -> IndexedDatabase:
    """Restore a database checkpoint written by :func:`save_database`."""
    import json as _json

    from ..chem.enzyme import Position
    from ..chem.modification import ModificationSpecificity

    z = np.load(path, allow_pickle=False)
    meta = _json.loads(bytes(z["meta"].tobytes()).decode())
    if meta["version"] != CHECKPOINT_VERSION:
        raise ValueError(f"unsupported checkpoint version {meta['version']}")
    seq_lens = z["seq_lens"]
    seq_flat = z["seq_flat"].tobytes()
    mods_flat = z["mods_flat"]
    nterm, cterm = z["nterm"], z["cterm"]
    mono, decoy = z["mono"], z["decoy"]
    mc, semi, pos = z["missed_cleavages"], z["semi"], z["position"]
    prot_offsets = z["prot_offsets"]
    prot_all = z["prot_flat"].tobytes().decode()
    prot_items = prot_all.split("\x00") if prot_all else []

    # Rebuilding ~1M Peptide objects dominates load time, so every
    # per-element numpy scalar op is hoisted into one vectorized
    # conversion per column (measured ~7x on a 889k-peptide checkpoint;
    # the columnar table below bypasses the objects entirely).
    n_pep = int(seq_lens.shape[0])
    seq_offs = np.concatenate(
        [np.zeros(1, np.int64), np.cumsum(seq_lens, dtype=np.int64)]
    ).tolist()
    mods_all = mods_flat.tolist()  # exact: f32 widens losslessly to f64
    # list() (NOT .tolist(), which unboxes to Python float) keeps the
    # np.float32 scalars the object API promises — float64 formatting
    # would change TSV bytes downstream
    nt_vals = [
        None if isn else v for v, isn in zip(list(nterm), np.isnan(nterm).tolist())
    ]
    ct_vals = [
        None if isn else v for v, isn in zip(list(cterm), np.isnan(cterm).tolist())
    ]
    mono_l = list(mono)
    decoy_l = decoy.tolist()
    mc_l = mc.tolist()
    semi_l = semi.tolist()
    pos_cache = {int(v): Position(int(v)) for v in np.unique(pos)}
    pos_l = pos.tolist()
    po = prot_offsets.tolist()
    peptides: List[Peptide] = []
    for i in range(n_pep):
        so, eo = seq_offs[i], seq_offs[i + 1]
        peptides.append(
            Peptide(
                decoy=decoy_l[i],
                sequence=seq_flat[so:eo],
                modifications=mods_all[so:eo],
                nterm=nt_vals[i],
                cterm=ct_vals[i],
                monoisotopic=mono_l[i],
                missed_cleavages=mc_l[i],
                semi_enzymatic=semi_l[i],
                position=pos_cache[pos_l[i]],
                proteins=prot_items[po[i] : po[i + 1]],
            )
        )

    table = PeptideTable.from_columns(
        seq_flat, seq_lens, mods_flat, nterm, cterm, mono, decoy, mc,
        semi, pos,
    )
    potential_mods = [
        (ModificationSpecificity.parse(s), np.float32(m))
        for s, m in meta["potential_mods"]
    ]
    # The flat m/z-sorted view is a permutation of the bucketed arrays;
    # rebuild it rather than storing it twice.
    forder = np.argsort(z["fragment_mz"], kind="stable")
    return IndexedDatabase(
        fragment_mz_flat=z["fragment_mz"][forder],
        fragment_pep_flat=z["fragment_pep"][forder],
        peptides=peptides,
        table=table,
        fragment_mz=z["fragment_mz"],
        fragment_pep=z["fragment_pep"],
        bucket_min=z["bucket_min"],
        bucket_size=int(meta["bucket_size"]),
        ion_kinds=tuple(meta["ion_kinds"]),
        min_ion_index=int(meta["min_ion_index"]),
        generate_decoys=bool(meta["generate_decoys"]),
        decoy_tag=meta["decoy_tag"],
        potential_mods=potential_mods,
    )
