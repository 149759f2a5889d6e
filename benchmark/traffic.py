"""The one traffic generator: spectra drawn from a seeded proteome's
peptides, as a traffic file's parameters ask.

Each spectrum is drawn from a target peptide (its singly charged b/y ions
kept at random, doubly charged ones too at precursor charge 3, plus
noise peaks), or is a weak "null" spectrum of a target or a decoy
(interior reversed) peptide with fewer of its ions kept, which gives the
rescoring its decoy class, or is noise alone. Where the configuration's precursor
window is wide enough, a share of the precursors carries an unmodelled
mass shift on one residue, which moves the precursor and every ion that
holds the residue. Where the configuration searches isotope errors, a
share of the precursors is read at a heavier isotope (the instrument
picked the wrong peak of the envelope). Reporter-ion peaks are added where the configuration
quantifies an isobaric label. Nothing here imports the program: spectra
are plain arrays, and the harness hands them to the program.

Adapted from the port's ``bench_baseline.synth_spectra`` (which drew
charge-2 peptides from the program's own database).
"""

from __future__ import annotations

import base64
import dataclasses
import zlib
from typing import List, Optional, Sequence, Tuple

import numpy as np

from .proteome import (
    NEUTRON, PROTON, Enzyme, Mods, Peptide, fasta_text, proteome,
)

F32 = np.float32

TMT11_MZ = [126.127726, 127.124761, 127.131081, 128.128116, 128.134436,
            129.131471, 129.13779, 130.134825, 130.141145, 131.13818,
            131.144499]


@dataclasses.dataclass
class Spectrum:
    """One MS2 spectrum. ``mz`` are singly-charged-equivalent peak
    positions (neutral mass + proton), ascending; ``truth`` is the peptide
    it was drawn from (None for noise), ``shift`` its unmodelled mass
    shift and ``isotope`` the isotope its precursor was read at."""

    id: str
    rt: float
    prec_mz: float
    charge: int
    mz: np.ndarray  # f64
    intensity: np.ndarray  # f32
    truth: Optional[Peptide]
    shift: float
    isotope: int = 0


@dataclasses.dataclass
class Workload:
    """What a cell feeds the program: its FASTA text and spectra."""

    fasta: str
    spectra: List[Spectrum]
    proteins: List[Tuple[str, str]]


def _window_da(sage_cfg: dict) -> Tuple[float, float]:
    """The precursor window's (lo, hi) in Da, or (0, 0) for ppm."""
    (kind, (lo, hi)), = sage_cfg["precursor_tol"].items()
    return (float(lo), float(hi)) if kind == "da" else (0.0, 0.0)


def _isotopes(sage_cfg: dict, traffic: dict) -> Tuple[List[int], List[float]]:
    """The traffic's isotope offsets that the configuration searches, and
    their weights (renormalised); empty where it searches none."""
    lo, hi = (sage_cfg.get("isotope_errors") or [0, 0])[:2]
    pairs = [(int(k), float(w)) for k, w in
             zip(traffic.get("isotopes", []), traffic.get("isotope_weights", []))
             if int(lo) <= int(k) <= int(hi) and int(k) != 0]
    total = sum(w for _, w in pairs)
    return [k for k, _ in pairs], [w / total for _, w in pairs]


def _isotope_clash(mz: np.ndarray, zmax: int, ppm: float = 20.0) -> bool:
    """True if two peaks lie an isotope spacing (NEUTRON / z, z up to
    ``zmax``) apart within ``ppm``: a deisotoping step could merge them."""
    s = np.sort(mz)
    for z in range(1, zmax + 1):
        step = float(NEUTRON) / z
        j = np.searchsorted(s, s + step)
        for off in (-1, 0):
            k = np.clip(j + off, 0, s.size - 1)
            if np.any(np.abs(s[k] - s - step) <= ppm * 1e-6 * s):
                return True
    return False


def generate(config: dict, traffic: dict, seed: int,
             n_spectra: Optional[int] = None) -> Workload:
    """The cell's proteome and ``n_spectra`` spectra (the traffic's
    ``spectra`` by default). The proteome (the configuration's own seed)
    and the set of spectra (the traffic's ``spectra_seed``) are the same
    for every run, so that every run does the same work; ``seed`` puts
    the spectra in its own order (scan numbers and retention times
    follow the order)."""
    sage = config["sage"]
    db = sage["database"]
    prot = proteome(config["proteome"]["proteins"],
                    config["proteome"]["length"], config["proteome"]["seed"])
    enzyme = Enzyme(db.get("enzyme") or {})
    mods = Mods(db)
    min_mass = float(db.get("peptide_min_mass") or 500.0)
    max_mass = float(db.get("peptide_max_mass") or 5000.0)
    n = int(n_spectra if n_spectra is not None else traffic["spectra"])
    rng = np.random.default_rng([int(traffic["spectra_seed"]),
                                 int(config["proteome"]["seed"]), n])
    lo_da, hi_da = _window_da(sage)
    # a shift is unmodelled only where the window still holds the peptide
    shifts = [s for s in traffic.get("shifts", []) if lo_da <= -s <= hi_da
              and (lo_da, hi_da) != (0.0, 0.0)]
    isotopes, iso_weights = _isotopes(sage, traffic)
    reporters = (TMT11_MZ if (sage.get("quant") or {}).get("tmt") == "Tmt11"
                 else [])
    deisotope = sage.get("deisotope", True)
    min_len = max(int(traffic["min_len"]), enzyme.min_len)
    spectra: List[Spectrum] = []
    i = 0
    while len(spectra) < n:
        i += 1
        if i > 100 * n + 1000:
            raise RuntimeError("the traffic's constraints reject nearly every draw")
        z = int(rng.choice(traffic["charges"], p=traffic["charge_weights"]))
        kind = rng.random()
        noise = kind < traffic["noise_share"]
        null = not noise and kind < traffic["noise_share"] + traffic["null_share"]
        pep, shift, iso, frags = None, 0.0, 0, np.zeros(0)
        if not noise:
            drawn = _draw_peptide(rng, prot, enzyme, mods, min_len,
                                  min_mass, max_mass, traffic)
            if drawn is None:
                continue
            pep = drawn
            if null and rng.random() < 0.5:
                pep = pep.reversed(mods)
            b, y = pep.ladders()
            site = -1
            if shifts and not null and rng.random() < traffic["shift_share"]:
                shift = float(rng.choice(shifts))
                site = int(rng.integers(0, len(pep.seq)))
            k = np.arange(b.size)
            b = b.astype(np.float64) + np.where(k >= site, shift, 0.0) * (site >= 0)
            y = y.astype(np.float64) + np.where(k < site, shift, 0.0) * (site >= 0)
            ions = np.concatenate([b, y])
            keep = traffic["null_keep" if null else "fragment_keep"]
            keep1 = rng.random(ions.size) < keep
            parts = [ions[keep1]]
            if z >= 3:
                keep2 = rng.random(ions.size) < keep * traffic["z2_share"]
                parts.append(ions[keep2] / 2.0)
            frags = np.concatenate(parts)
            # the ions an unshifted ladder still matches, away from the
            # index's first two ions of each series
            unshifted = np.concatenate([(k >= 2) & ((k < site) | (site < 0)),
                                        (b.size - k > 2) & (k >= site)])
            if int(np.sum(keep1 & unshifted)) < traffic["min_visible_ions"]:
                continue
            mass = float(pep.mono) + shift
            if isotopes and rng.random() < traffic["isotope_share"]:
                iso = int(rng.choice(isotopes, p=iso_weights))
                mass += iso * float(NEUTRON)
        else:
            mass = float(rng.uniform(traffic["noise_mass"][0],
                                     traffic["noise_mass"][1]))
        top = max(mass, 400.0)
        noise_mz = rng.uniform(150.0, top, size=int(traffic["noise_peaks"]))
        peaks = np.concatenate([frags, noise_mz]) + float(PROTON)
        peaks = np.sort(peaks[(peaks > 150.0) & (peaks < 4000.0)])
        # reporter ions sit below every fragment, where the engine does
        # not deisotope at TMT level 2
        if deisotope and _isotope_clash(peaks, max(z, 3)):
            continue
        if reporters:
            peaks = np.concatenate([reporters, peaks])
        if peaks.size > traffic["max_peaks"] or peaks.size < traffic["min_peaks"]:
            continue
        inten = rng.uniform(1e3, 1e6, size=peaks.size).astype(np.float32)
        prec_mz = (mass + z * float(PROTON)) / z
        spectra.append(Spectrum(
            id="", rt=0.0, prec_mz=prec_mz, charge=z, mz=peaks,
            intensity=inten, truth=pep, shift=shift, isotope=iso))
    order = np.random.default_rng([int(seed) % (1 << 63), 0x5EC7]).permutation(n)
    spectra = [spectra[k] for k in order]
    for i, s in enumerate(spectra):
        s.id, s.rt = f"scan={i + 1}", 0.05 + 0.004 * i
    return Workload(fasta=fasta_text(prot), spectra=spectra, proteins=prot)


def _draw_peptide(rng, prot, enzyme: Enzyme, mods: Mods, min_len: int,
                  min_mass: float, max_mass: float, traffic: dict):
    acc, seq = prot[int(rng.integers(0, len(prot)))]
    spans = [(s, e) for s, e, _ in enzyme.spans(seq)
             if min_len <= e - s <= traffic["max_len"]]
    if not spans:
        return None
    s, e = spans[int(rng.integers(0, len(spans)))]
    text = seq[s:e]
    var_sites = []
    for aa in mods.variable:
        for j, c in enumerate(text):
            if (c == aa and len(var_sites) < mods.max_variable
                    and rng.random() < traffic["variable_share"]):
                var_sites.append(j)
    pep = Peptide(text, var_sites, mods)
    # keep away from the mass filter's edges
    if not (min_mass + 5.0 <= float(pep.mono) <= max_mass - 5.0):
        return None
    return pep


def processed_masses(mz: np.ndarray) -> np.ndarray:
    """Peak m/z to the neutral f32 masses a spectrum processor gives them
    at charge 1: ``(f32(mz) - PROTON) * 1``."""
    return ((mz.astype(np.float32) - PROTON) * F32(1.0)).astype(np.float32)


def _enc(arr, dtype) -> str:
    return base64.b64encode(
        zlib.compress(np.ascontiguousarray(arr, dtype).tobytes())).decode()


def write_mzml(path: str, spectra: Sequence[Spectrum]) -> None:
    """The spectra as an indexed-free mzML of centroided MS2 scans."""
    with open(path, "w") as f:
        f.write('<?xml version="1.0"?><mzML><run><spectrumList>')
        for s in spectra:
            f.write(
                f'<spectrum id="{s.id}">'
                '<cvParam accession="MS:1000511" value="2"/>'
                '<cvParam accession="MS:1000127" value=""/>'
                f'<cvParam accession="MS:1000285" value="{float(s.intensity.sum())!r}"/>'
                "<scanList><scan>"
                f'<cvParam accession="MS:1000016" value="{s.rt!r}" '
                'unitAccession="UO:0000031"/>'
                "</scan></scanList><precursorList><precursor>"
                "<selectedIonList><selectedIon>"
                f'<cvParam accession="MS:1000744" value="{s.prec_mz!r}"/>'
                f'<cvParam accession="MS:1000041" value="{s.charge}"/>'
                "</selectedIon></selectedIonList></precursor></precursorList>"
                "<binaryDataArrayList>"
                '<binaryDataArray><cvParam accession="MS:1000523" value=""/>'
                '<cvParam accession="MS:1000574" value=""/>'
                '<cvParam accession="MS:1000514" value=""/>'
                f"<binary>{_enc(s.mz, np.float64)}</binary></binaryDataArray>"
                '<binaryDataArray><cvParam accession="MS:1000521" value=""/>'
                '<cvParam accession="MS:1000574" value=""/>'
                '<cvParam accession="MS:1000515" value=""/>'
                f"<binary>{_enc(s.intensity, np.float32)}</binary>"
                "</binaryDataArray></binaryDataArrayList></spectrum>"
            )
        f.write("</spectrumList></run></mzML>")
