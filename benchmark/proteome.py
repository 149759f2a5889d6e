"""Plain peptide chemistry for the benchmark: a seeded random proteome,
tryptic digestion, modifications and f32 masses and ion ladders in the
search engine's order of operations.

This module imports nothing of the program under test. The traffic
generator draws its peptides from it, the reference judge recomputes the
masses and ladders of reported peptides with it, and the roofline counts
enumerate the candidates a window holds with it.
"""

from __future__ import annotations

import re
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

F32 = np.float32

AMINO_ACIDS = "ACDEFGHIKLMNPQRSTVWY"

# monoisotopic residue masses (Da), as f32
RESIDUE_MASS = {
    "A": 71.03711, "C": 103.00919, "D": 115.02694, "E": 129.04259,
    "F": 147.0684, "G": 57.02146, "H": 137.05891, "I": 113.08406,
    "K": 128.09496, "L": 113.08406, "M": 131.0405, "N": 114.04293,
    "P": 97.05276, "Q": 128.05858, "R": 156.1011, "S": 87.03203,
    "T": 101.04768, "V": 99.06841, "W": 186.07932, "Y": 163.06332,
}
_MASS_LUT = np.zeros(128, np.float32)
for _aa, _m in RESIDUE_MASS.items():
    _MASS_LUT[ord(_aa)] = F32(_m)

H2O = F32(18.010565)
PROTON = F32(1.0072764)
NEUTRON = F32(1.00335)


def proteome(n_proteins: int, length: int, seed: int) -> List[Tuple[str, str]]:
    """``n_proteins`` random sequences of ``length`` residues, uniform
    over the 20 amino acids, as (accession, sequence) pairs."""
    rng = np.random.default_rng([int(seed), 0xFA57A])
    letters = np.frombuffer(AMINO_ACIDS.encode(), np.uint8)
    seqs = letters[rng.integers(0, 20, size=(n_proteins, length))]
    return [(f"sp|SYN{i:05d}|SYN{i}_HUMAN", seqs[i].tobytes().decode())
            for i in range(n_proteins)]


def fasta_text(proteins: Sequence[Tuple[str, str]]) -> str:
    return "".join(f">{acc} synthetic\n{seq}\n" for acc, seq in proteins)


class Enzyme:
    """Trypsin-style digestion as a Sage config states it: cleave after
    any residue of ``cleave_at`` unless the next residue is in
    ``restrict``; spans of up to ``missed_cleavages + 1`` pieces of
    ``min_len`` to ``max_len`` residues."""

    def __init__(self, cfg: dict):
        self.missed = int(cfg.get("missed_cleavages", 1))
        self.min_len = int(cfg.get("min_len", 5))
        self.max_len = int(cfg.get("max_len", 50))
        self.cleave = cfg.get("cleave_at", "KR")
        self.restrict = cfg.get("restrict", "")
        self._site = re.compile("[%s]" % self.cleave)

    def sites(self, seq: str) -> List[int]:
        """Cut positions, the protein's ends included."""
        cuts = [0]
        for m in self._site.finditer(seq):
            r = m.end()
            if r < len(seq) and seq[r] in self.restrict:
                continue
            cuts.append(r)
        if cuts[-1] != len(seq):
            cuts.append(len(seq))
        return cuts

    def spans(self, seq: str) -> List[Tuple[int, int, int]]:
        """(start, end, missed cleavages) of every peptide of the protein."""
        cuts = self.sites(seq)
        out = []
        for i in range(len(cuts) - 1):
            for mc in range(self.missed + 1):
                j = i + mc + 1
                if j >= len(cuts):
                    break
                n = cuts[j] - cuts[i]
                if self.min_len <= n <= self.max_len:
                    out.append((cuts[i], cuts[j], mc))
        return out


class Mods:
    """A config's static and variable modifications: residue letters and
    ``^`` (the peptide's N-terminus)."""

    def __init__(self, db_cfg: dict):
        self.static: Dict[str, float] = {
            k: float(v) for k, v in (db_cfg.get("static_mods") or {}).items()}
        var = db_cfg.get("variable_mods") or {}
        self.variable: Dict[str, float] = {}
        for k, v in var.items():
            vals = v if isinstance(v, list) else [v]
            if len(vals) != 1:
                raise ValueError("one variable mass per site is supported")
            self.variable[k] = float(vals[0])
        self.max_variable = max(int(db_cfg.get("max_variable_mods") or 2), 1)

    def residue_mod(self, aa: str, variable: bool) -> float:
        if variable:
            return self.variable[aa]
        return self.static.get(aa, 0.0)

    @property
    def nterm(self) -> Optional[float]:
        return self.static.get("^")


class Peptide:
    """A peptide as (sequence, positions carrying the variable mod), with
    the config's static mods applied and its masses in f32."""

    __slots__ = ("seq", "var_sites", "mods", "nterm", "mono", "resmass")

    def __init__(self, seq: str, var_sites: Sequence[int], mods: Mods,
                 mono: Optional[np.float32] = None):
        self.seq = seq
        self.var_sites = tuple(sorted(var_sites))
        per = [F32(0.0)] * len(seq)
        for i in self.var_sites:
            per[i] = F32(mods.residue_mod(seq[i], True))
        for i, aa in enumerate(seq):
            if per[i] == 0.0 and aa in mods.static:
                per[i] = F32(mods.static[aa])
        self.mods = per
        nt = mods.nterm
        self.nterm = F32(nt) if nt is not None else None
        # H2O + residues, one f32 add each; then the mods' own f32 sum
        mass = H2O
        for aa in seq:
            mass = F32(mass + _MASS_LUT[ord(aa)])
        acc = F32(0.0)
        for m in per:
            acc = F32(acc + m)
        acc = F32(acc + (self.nterm if self.nterm is not None else F32(0.0)))
        self.mono = F32(mass + acc) if mono is None else F32(mono)
        self.resmass = np.array(
            [F32(_MASS_LUT[ord(aa)] + m) for aa, m in zip(seq, per)],
            np.float32)

    def reversed(self, mods: Mods) -> "Peptide":
        """The decoy: the interior (all but the first and last residue)
        reversed with its mods, the target's mass kept as it is."""
        n = len(self.seq)
        if n <= 2:
            return Peptide(self.seq, self.var_sites, mods, self.mono)
        seq = self.seq[0] + self.seq[1:-1][::-1] + self.seq[-1]
        sites = [i if i in (0, n - 1) else n - 1 - i for i in self.var_sites]
        return Peptide(seq, sites, mods, self.mono)

    def ladders(self) -> Tuple[np.ndarray, np.ndarray]:
        """b and y neutral ion masses, ion ``k`` for k < len - 1: b[k] =
        nterm + residues 0..k, y[k] = (mono - nterm) - residues 0..k, each
        a running f32 sum."""
        nt = self.nterm if self.nterm is not None else F32(0.0)
        n = len(self.seq) - 1
        b = np.cumsum(np.r_[np.float32(nt), self.resmass[:n]],
                      dtype=np.float32)[1:]
        y = np.cumsum(np.r_[F32(self.mono - nt), -self.resmass[:n]],
                      dtype=np.float32)[1:]
        return b, y


_TOKEN = re.compile(r"([A-Z])(?:\[([+-][0-9.]+)\])?")
_NTERM = re.compile(r"^\[([+-][0-9.]+)\]-")


def parse_display(text: str, mods: Mods, decoy: bool = False) -> Optional[Peptide]:
    """A reported display string back to a :class:`Peptide`, its masses
    taken from the config: None if a bracket is not a mass that the
    config puts on that residue or terminus. A decoy's mass is its
    target's (the engine reverses a target and keeps its mass)."""
    nt = _NTERM.match(text)
    body = text[nt.end():] if nt else text
    if (nt is not None) != (mods.nterm is not None):
        return None
    if nt is not None and abs(float(nt.group(1)) - mods.nterm) > 1e-3:
        return None
    seq, var_sites = [], []
    pos = 0
    for m in _TOKEN.finditer(body):
        if m.start() != pos:
            return None
        pos = m.end()
        aa, val = m.group(1), m.group(2)
        i = len(seq)
        seq.append(aa)
        if aa not in RESIDUE_MASS:
            return None
        if val is None:
            if aa in mods.static:
                return None
            continue
        v = float(val)
        if aa in mods.static and abs(v - mods.static[aa]) <= 1e-3:
            continue
        if aa in mods.variable and abs(v - mods.variable[aa]) <= 1e-3:
            var_sites.append(i)
            continue
        return None
    if pos != len(body) or len(var_sites) > mods.max_variable:
        return None
    pep = Peptide("".join(seq), var_sites, mods)
    if decoy:
        # the decoy carries its target's mass: un-reverse, then reverse
        target = pep.reversed(mods)
        pep = Peptide(target.seq, target.var_sites, mods).reversed(mods)
    return pep


def peptide_masses(proteins: Sequence[Tuple[str, str]], enzyme: Enzyme,
                   mods: Mods, min_mass: float, max_mass: float):
    """Every target peptide's monoisotopic mass (f64; variable-mod forms
    included), its length and its count of variable-mod sites: the
    candidates of a precursor window, for the roofline counts. Decoys
    (interior reversed) have their target's mass, so a window holds twice
    these. Masses are f64 sums, good for counting and not for matching."""
    seqs = {}
    for _, seq in proteins:
        for s, e, _mc in enzyme.spans(seq):
            seqs[seq[s:e]] = True
    uniq = list(seqs)
    if not uniq:
        return np.zeros(0), np.zeros(0, np.int32)
    lens = np.fromiter((len(s) for s in uniq), np.int64, len(uniq))
    flat = np.frombuffer("".join(uniq).encode(), np.uint8)
    per = _MASS_LUT.astype(np.float64)[flat]
    for aa, m in mods.static.items():
        if aa in RESIDUE_MASS:
            per = per + np.where(flat == ord(aa), m, 0.0)
    ends = np.cumsum(lens)
    csum = np.r_[0.0, np.cumsum(per)]
    base = csum[ends] - csum[ends - lens] + float(H2O) + (mods.nterm or 0.0)
    masses, lengths = [base], [lens]
    for aa, m in mods.variable.items():
        hits = np.r_[0, np.cumsum(flat == ord(aa))]
        k_sites = hits[ends] - hits[ends - lens]
        from math import comb
        for k in range(1, mods.max_variable + 1):
            ways = np.array([comb(int(c), k) for c in k_sites], np.int64)
            sel = ways > 0
            masses.append(np.repeat(base[sel] + k * m, ways[sel]))
            lengths.append(np.repeat(lens[sel], ways[sel]))
    mass = np.concatenate(masses)
    length = np.concatenate(lengths)
    keep = (mass >= min_mass) & (mass <= max_mass)
    order = np.argsort(mass[keep], kind="stable")
    return mass[keep][order], length[keep][order].astype(np.int32)
