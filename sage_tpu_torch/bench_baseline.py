"""Deterministic synthetic workload: a random proteome and spectra drawn
from its peptides' b/y ladders. The same generators the JAX package's
benchmark uses, so both packages can be driven with identical inputs;
:func:`synth_tdf` writes such spectra as a Bruker timsTOF ``.d``.
"""

from __future__ import annotations

import os
import sqlite3
import struct
from typing import List

import numpy as np

from .chem.mass import NEUTRON, PROTON

_AA = np.frombuffer(b"ACDEFGHIKLMNPQRSTVWY", dtype=np.uint8)


def synth_fasta(n_proteins: int, length: int = 360, seed: int = 7) -> str:
    """Deterministic random proteome used by bench.py and the baseline
    parity tests."""
    rng = np.random.default_rng(seed)
    lines = []
    for i in range(n_proteins):
        seq = _AA[rng.integers(0, len(_AA), size=length)].tobytes().decode()
        lines.append(f">sp|BENCH{i:05d}|BENCH{i}_SYN synthetic\n{seq}")
    return "\n".join(lines)


def synth_spectra(db, n_spectra: int, seed: int = 11) -> List:
    """Spectra whose peaks are a peptide's b/y ions (plus noise), precursor
    annotated at charge 2 — exercising the real narrow-search path."""
    from .spectrum.processor import Precursor, ProcessedSpectrum

    rng = np.random.default_rng(seed)
    b, y = db.table.ladders()
    mono = db.table.mono
    lens = db.table.lens
    out = []
    n_pep = len(db)
    for i in range(n_spectra):
        p = int(rng.integers(0, n_pep))
        n = max(int(lens[p]) - 1, 1)
        frags = np.concatenate([b[p, :n], y[p, :n]])
        take = rng.random(frags.shape[0]) < 0.7
        masses = frags[take]
        noise = rng.uniform(150.0, float(mono[p]), size=60).astype(np.float32)
        masses = np.concatenate([masses, noise]).astype(np.float32)
        intens = rng.uniform(1e3, 1e6, size=masses.shape[0]).astype(np.float32)
        order = np.argsort(masses, kind="stable")
        masses, intens = masses[order], intens[order]
        z = 2
        prec_mz = float(np.float32(mono[p]) / z + PROTON)
        out.append(
            ProcessedSpectrum(
                level=2,
                id=f"scan={i}",
                file_id=0,
                scan_start_time=float(i) * 0.01,
                ion_injection_time=1.0,
                precursors=[Precursor(mz=prec_mz, charge=z)],
                masses=masses,
                intensities=intens,
                mobilities=np.zeros(0, np.float32),
                total_ion_current=np.float32(intens.sum()),
            )
        )
    return out


# the synthetic .d's acquisition ranges (a timsTOF's usual m/z range and
# 1/K0 span), its TOF digitizer's sample count, and its ddaPASEF layout:
# precursors a block, PASEF frames a block, scans a frame, seconds a frame
TDF_MZ = (100.0, 1700.0)
TDF_SAMPLES = 400000
TDF_IM = (0.6, 1.6)
TDF_PER_FRAME = 10
TDF_REPEATS = 2
TDF_SCANS = 200
TDF_FRAME_S = 0.1


def _tdf_frame(scan, tof, inten, num_scans: int) -> bytes:
    """One type-0 (uncompressed) tdf_bin frame block: entries at the same
    (scan, TOF index) summed, each scan's TOF indices delta-coded."""
    key = (scan.astype(np.int64) << 32) | tof.astype(np.int64)
    uk, inv = np.unique(key, return_inverse=True)
    total = np.bincount(inv, weights=inten.astype(np.float64))
    scan, tof = uk >> 32, uk & 0xFFFFFFFF
    first = np.ones(uk.size, bool)
    first[1:] = scan[1:] != scan[:-1]
    delta = np.where(first, tof, tof - np.concatenate([[0], tof[:-1]]))
    pairs = np.empty(2 * uk.size, np.uint32)
    pairs[0::2] = delta
    pairs[1::2] = total
    counts = 2 * np.bincount(scan, minlength=num_scans)
    payload = np.concatenate([counts.astype(np.uint32), pairs]).tobytes()
    return struct.pack("<II", len(payload) + 8, num_scans) + payload


def synth_tdf(path: str, spectra, seed: int = 5) -> None:
    """Write ``spectra`` (as :func:`synth_spectra` makes them: neutral
    fragment masses, singly charged) as a synthetic ddaPASEF Bruker ``.d``
    directory of type-0 frames.

    The precursors go in blocks of ``TDF_PER_FRAME``; each block is one
    MS1 frame followed by ``TDF_REPEATS`` PASEF MS2 frames that fragment
    the same precursors, each over its own range of 4-12 scans. A precursor's
    peaks (m/z quantised to the TOF calibration's index) are split over
    1-3 random (frame, scan) cells of its ranges, so that the reader's
    summing over frames and scans gives them back. The MS1 frame carries
    each precursor's three-isotope envelope over its scans plus noise."""
    rng = np.random.default_rng(seed)
    per_frame, repeats, num_scans = TDF_PER_FRAME, TDF_REPEATS, TDF_SCANS
    lo, hi = np.sqrt(TDF_MZ[0]), np.sqrt(TDF_MZ[1])

    def to_tof(mz):
        t = np.rint((np.sqrt(mz) - lo) / (hi - lo) * (TDF_SAMPLES - 1))
        keep = (mz > TDF_MZ[0]) & (mz < TDF_MZ[1])
        return t.astype(np.int64), keep

    os.makedirs(path, exist_ok=True)
    frames, pasef, precursors = [], [], []
    with open(os.path.join(path, "analysis.tdf_bin"), "wb") as fbin:
        def frame(kind, scan, tof, inten):
            fid = len(frames) + 1
            frames.append((fid, fid * TDF_FRAME_S, kind, fbin.tell(),
                           num_scans))
            fbin.write(_tdf_frame(scan, tof, inten, num_scans))
            return fid

        for b0 in range(0, len(spectra), per_frame):
            block = spectra[b0:b0 + per_frame]
            widths = rng.integers(4, 13, len(block))
            starts = np.arange(len(block)) * (num_scans // per_frame)
            # MS1: each precursor's isotope envelope over its scans
            ms1 = [(rng.integers(0, num_scans, 64),
                    rng.uniform(*TDF_MZ, 64), rng.integers(100, 1000, 64))]
            for s, s0, w in zip(block, starts, widths):
                p = s.precursors[0]
                mz = p.mz + NEUTRON * np.arange(3) / p.charge
                amp = rng.uniform(1e4, 1e6) * np.array([1.0, 0.6, 0.25])
                sc = s0 + np.arange(w)
                prof = np.exp(-0.5 * ((sc - sc.mean()) / (w / 4)) ** 2)
                ms1.append((np.repeat(sc, 3), np.tile(mz, w),
                            np.rint(np.outer(prof, amp)).ravel()))
            sc, mz, it = (np.concatenate(v) for v in zip(*ms1))
            tof, keep = to_tof(mz)
            parent = frame(0, sc[keep], tof[keep], it[keep])
            # MS2: the block's peaks split over (frame, scan) cells
            cells = [[] for _ in range(repeats)]
            for s, s0, w in zip(block, starts, widths):
                tof, keep = to_tof(s.masses.astype(np.float64) + PROTON)
                tof = tof[keep]
                inten = np.rint(s.intensities[keep]).astype(np.int64)
                m = rng.integers(1, 4, tof.size)
                own = np.repeat(np.arange(tof.size), m)
                wt = rng.random(own.size) + 0.1
                part = np.floor(inten[own] * wt
                                / np.bincount(own, wt)[own]).astype(np.int64)
                part[np.cumsum(m) - m] += inten - np.bincount(
                    own, part, minlength=tof.size).astype(np.int64)
                rep = rng.integers(0, repeats, own.size)
                scan = s0 + rng.integers(0, w, own.size)
                for r in range(repeats):
                    sel = rep == r
                    cells[r].append((scan[sel], tof[own][sel], part[sel]))
            fids = [frame(8, *(np.concatenate(v) for v in zip(*cells[r])))
                    for r in range(repeats)]
            for s, s0, w in zip(block, starts, widths):
                p = s.precursors[0]
                pid = len(precursors) + 1
                precursors.append((pid, p.mz + 0.01, p.mz, p.mz, p.charge,
                                   float(s0 + w / 2), float(s.intensities.sum()),
                                   parent))
                pasef += [(f, int(s0), int(s0 + w), p.mz, 2.0, 30.0, pid)
                          for f in fids]
    con = sqlite3.connect(os.path.join(path, "analysis.tdf"))
    try:
        con.executescript(TDF_SCHEMA)
        meta = {
            "TimsCompressionType": "0",
            "MzAcqRangeLower": str(TDF_MZ[0]),
            "MzAcqRangeUpper": str(TDF_MZ[1]),
            "DigitizerNumSamples": str(TDF_SAMPLES),
            "OneOverK0AcqRangeLower": str(TDF_IM[0]),
            "OneOverK0AcqRangeUpper": str(TDF_IM[1]),
        }
        con.executemany("INSERT INTO GlobalMetadata VALUES (?, ?)",
                        meta.items())
        con.executemany("INSERT INTO Frames VALUES (?, ?, ?, ?, ?)", frames)
        con.executemany(
            "INSERT INTO PasefFrameMsMsInfo VALUES (?, ?, ?, ?, ?, ?, ?)",
            pasef)
        con.executemany(
            "INSERT INTO Precursors VALUES (?, ?, ?, ?, ?, ?, ?, ?)",
            precursors)
        con.commit()
    finally:
        con.close()


# the tables and columns of analysis.tdf that the reader uses
TDF_SCHEMA = """
CREATE TABLE GlobalMetadata (Key TEXT, Value TEXT);
CREATE TABLE Frames (Id INTEGER, Time REAL, MsMsType INTEGER,
                     TimsId INTEGER, NumScans INTEGER);
CREATE TABLE PasefFrameMsMsInfo (Frame INTEGER, ScanNumBegin INTEGER,
    ScanNumEnd INTEGER, IsolationMz REAL, IsolationWidth REAL,
    CollisionEnergy REAL, Precursor INTEGER);
CREATE TABLE Precursors (Id INTEGER, LargestPeakMz REAL,
    AverageMz REAL, MonoisotopicMz REAL, Charge INTEGER,
    ScanNumber REAL, Intensity REAL, Parent INTEGER);
"""
