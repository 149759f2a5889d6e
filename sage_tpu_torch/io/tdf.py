"""Bruker timsTOF `.d` (TDF) reader: ddaPASEF MS2 + centroided MS1.

Counterpart of ``sage_tpu/io/tdf.py``, host code in numpy and sqlite3;
parity target crates/sage-cloudpath/src/tdf.rs, which reads .d
directories via the `timsrust` crate. This implementation reads the two
files directly:

* ``analysis.tdf`` — SQLite metadata: GlobalMetadata (compression type,
  m/z and 1/K0 acquisition ranges, digitizer samples), Frames (binary
  offsets, MS level), PasefFrameMsMsInfo (precursor -> frame/scan
  ranges + isolation window), Precursors (m/z, charge, intensity).
* ``analysis.tdf_bin`` — per-frame binary blocks:
  ``[u32 total_len][u32 num_scans][payload]``. TimsCompressionType 2
  payloads are zstd-compressed byte-plane-shuffled u32 streams (the
  OpenTIMS/alphatims layout: decompressed bytes reshape to [4, n] planes,
  transpose, view little-endian u32); type 0 is the raw stream. The u32
  stream holds ``num_scans`` per-scan entry counts (2x the pair count)
  followed by each scan's (tof-index delta, intensity) pairs, tof
  cumulative within the scan.

Conversions use the acquisition-range linear calibrations (as timsrust's
converters do): sqrt(m/z) linear in TOF index over [MzAcqRangeLower,
MzAcqRangeUpper]; 1/K0 linear (descending) in scan number over
[OneOverK0AcqRangeLower, OneOverK0AcqRangeUpper].

MS2: one RawSpectrum per PASEF precursor — peaks summed over its
frame/scan ranges grouped by TOF index, precursor m/z from
MonoisotopicMz (LargestPeakMz fallback), isolation width as a symmetric
Da Tolerance (tdf.rs:119-155). MS1: frames expand to (mz, intensity,
mobility) and pass through "fastcentroid" (tdf.rs:305-393): greedy
intensity-descending clustering within an m/z-ppm x mobility-pct window,
capped at 10k peaks.

zstd is in the standard library only from Python 3.14; type-2 frames
decode through the first importable codec of ``compression.zstd``,
``zstandard`` and pyarrow's, and raise a clear error without one.
tests/test_torch_tdf.py holds this reader against ``sage_tpu``'s on
synthetic .d directories, with type-0 and type-2 frames.
"""

from __future__ import annotations

import dataclasses
import logging
import os
import sqlite3
import struct
from typing import Dict, List, Optional, Tuple

import numpy as np

from ..chem.mass import Tolerance
from ..spectrum.processor import Precursor, RawSpectrum

log = logging.getLogger("sage_tpu_torch")

MAX_MS1_PEAKS = 10_000  # tdf.rs:311


@dataclasses.dataclass
class BrukerMs1Config:
    """fastcentroid window (tdf.rs:13-32)."""

    mz_ppm: float = 5.0
    ims_pct: float = 3.0


def _zstd_frame_content_size(data: bytes) -> Optional[int]:
    """Frame-header content size per RFC 8878 (when recorded)."""
    if len(data) < 6 or data[:4] != b"\x28\xb5\x2f\xfd":
        return None
    fhd = data[4]
    fcs_flag = fhd >> 6
    single_segment = (fhd >> 5) & 1
    dict_flag = fhd & 3
    pos = 5 + (0 if single_segment else 1) + (0, 1, 2, 4)[dict_flag]
    if fcs_flag == 0:
        if not single_segment:
            return None
        return data[pos]
    if fcs_flag == 1:
        return int.from_bytes(data[pos : pos + 2], "little") + 256
    if fcs_flag == 2:
        return int.from_bytes(data[pos : pos + 4], "little")
    return int.from_bytes(data[pos : pos + 8], "little")


def _zstd_decompress(data: bytes) -> bytes:
    try:
        from compression import zstd  # Python 3.14+

        return zstd.decompress(data)
    except ImportError:
        pass
    try:
        import zstandard

        return zstandard.ZstdDecompressor().decompress(data)
    except ImportError:
        pass
    try:
        import pyarrow as pa

        codec = pa.Codec("zstd")
        size = _zstd_frame_content_size(data)
        if size is not None:
            return codec.decompress(data, decompressed_size=size).to_pybytes()
        # pyarrow's zstd requires the exact decompressed size; without a
        # content size in the frame header it cannot decode this frame
        raise RuntimeError(
            "this .d frame's zstd header omits the content size; pyarrow's "
            "codec needs it — install the 'zstandard' package to read "
            "this file"
        )
    except ImportError:
        pass
    raise RuntimeError(
        "this .d file uses TimsCompressionType 2 (zstd); no zstd codec "
        "is importable (tried compression.zstd, zstandard, pyarrow)"
    )


class TofMzConverter:
    """sqrt(m/z) linear in TOF index over the acquisition range."""

    def __init__(self, mz_lo: float, mz_hi: float, n_samples: int):
        self.lo = np.sqrt(mz_lo)
        self.hi = np.sqrt(mz_hi)
        self.n = max(n_samples - 1, 1)

    def to_mz(self, tof: np.ndarray) -> np.ndarray:
        s = self.lo + (self.hi - self.lo) * tof.astype(np.float64) / self.n
        return (s * s).astype(np.float32)


class ScanImConverter:
    """1/K0 linear (descending) in scan number."""

    def __init__(self, im_lo: float, im_hi: float, n_scans: int):
        self.lo = im_lo
        self.hi = im_hi
        self.n = max(n_scans - 1, 1)

    def to_im(self, scan: np.ndarray) -> np.ndarray:
        frac = scan.astype(np.float64) / self.n
        return (self.hi - (self.hi - self.lo) * frac).astype(np.float32)


class TdfReader:
    def parse(
        self,
        path: str,
        file_id: int = 0,
        config: Optional[dict] = None,
        requires_ms1: bool = False,
    ) -> List[RawSpectrum]:
        """Read a `.d` directory (or a path to its analysis.tdf)."""
        cfg = BrukerMs1Config(**(config or {}))
        if path.endswith(".tdf") or path.endswith(".tdf_bin"):
            path = os.path.dirname(path)
        tdf = os.path.join(path, "analysis.tdf")
        tdf_bin = os.path.join(path, "analysis.tdf_bin")
        if not os.path.exists(tdf) or not os.path.exists(tdf_bin):
            raise FileNotFoundError(f"{path!r} is not a Bruker .d directory")

        con = sqlite3.connect(tdf)
        try:
            meta = dict(
                con.execute("SELECT Key, Value FROM GlobalMetadata").fetchall()
            )
            compression = int(meta.get("TimsCompressionType", 2))
            mz_lo = float(meta.get("MzAcqRangeLower", 100.0))
            mz_hi = float(meta.get("MzAcqRangeUpper", 1700.0))
            n_samples = int(float(meta.get("DigitizerNumSamples", 400000)))
            im_lo = float(meta.get("OneOverK0AcqRangeLower", 0.6))
            im_hi = float(meta.get("OneOverK0AcqRangeUpper", 1.6))

            frames = con.execute(
                "SELECT Id, Time, MsMsType, TimsId, NumScans FROM Frames "
                "ORDER BY Id"
            ).fetchall()
            frame_info = {
                int(fid): (float(t), int(mt), int(off), int(ns))
                for fid, t, mt, off, ns in frames
            }
            pasef = con.execute(
                "SELECT Frame, ScanNumBegin, ScanNumEnd, IsolationMz, "
                "IsolationWidth, Precursor FROM PasefFrameMsMsInfo "
                "ORDER BY Precursor, Frame"
            ).fetchall()
            precursors = con.execute(
                "SELECT Id, LargestPeakMz, MonoisotopicMz, Charge, "
                "Intensity, ScanNumber, Parent FROM Precursors"
            ).fetchall()
        finally:
            con.close()

        mz_conv = TofMzConverter(mz_lo, mz_hi, n_samples)

        # Decode each referenced frame once
        needed = {f for f, *_ in pasef}
        ms1_frames = [
            fid for fid, (_, mt, _, _) in frame_info.items() if mt == 0
        ]
        if requires_ms1:
            needed |= set(ms1_frames)
        decoded: Dict[int, Tuple[np.ndarray, np.ndarray, np.ndarray]] = {}
        with open(tdf_bin, "rb") as fh:
            for fid in sorted(needed):
                if fid not in frame_info:
                    continue
                _, _, offset, _ = frame_info[fid]
                decoded[fid] = _decode_frame(fh, offset, compression)

        spectra: List[RawSpectrum] = []

        # ---- MS2: one spectrum per PASEF precursor ----------------------
        by_precursor: Dict[int, List[Tuple[int, int, int, float, float]]] = {}
        for frame, s0, s1, iso_mz, iso_w, prec_id in pasef:
            by_precursor.setdefault(int(prec_id), []).append(
                (int(frame), int(s0), int(s1), float(iso_mz), float(iso_w))
            )

        for pid, lp_mz, mono_mz, charge, inten, scan_no, parent in precursors:
            groups = by_precursor.get(int(pid))
            if not groups:
                continue
            sel_tofs, sel_ints = [], []
            rt = 0.0
            iso_mz = iso_w = 0.0
            n_scans_parent = 1
            for frame, s0, s1, imz, iw in groups:
                info = frame_info.get(frame)
                if info is None or frame not in decoded:
                    continue
                rt, _, _, n_scans_parent = info
                iso_mz, iso_w = imz, iw
                scans, tofs, intens = decoded[frame]
                sel = (scans >= s0) & (scans < s1)
                sel_tofs.append(tofs[sel])
                sel_ints.append(intens[sel])
            if not sel_tofs:
                continue
            all_tofs = np.concatenate(sel_tofs)
            if all_tofs.size == 0:
                continue
            all_ints = np.concatenate(sel_ints)
            # group equal TOF indices, summing intensity (vectorized)
            tof_idx, inv = np.unique(all_tofs, return_inverse=True)
            mz = mz_conv.to_mz(tof_idx)
            intensity = np.bincount(
                inv, weights=all_ints.astype(np.float64),
                minlength=tof_idx.size,
            ).astype(np.float32)
            im_conv = ScanImConverter(im_lo, im_hi, n_scans_parent)
            prec_mz = mono_mz if mono_mz else lp_mz
            precursor = Precursor(
                mz=float(prec_mz or iso_mz),
                intensity=float(inten) if inten else None,
                charge=int(charge) if charge else None,
                spectrum_ref=(
                    f"frame={parent}" if parent is not None else None
                ),
                isolation_window=(
                    Tolerance("da", -iso_w / 2.0, iso_w / 2.0) if iso_w else None
                ),
                inverse_ion_mobility=float(
                    im_conv.to_im(np.array([scan_no or 0]))[0]
                ),
            )
            spectra.append(
                RawSpectrum(
                    file_id=file_id,
                    ms_level=2,
                    id=f"precursor={int(pid)}",
                    precursors=[precursor],
                    centroid=True,
                    scan_start_time=rt / 60.0,
                    total_ion_current=float(intensity.sum()),
                    mz=mz,
                    intensity=intensity,
                )
            )

        # ---- MS1 frames with fastcentroid --------------------------------
        if requires_ms1:
            for fid in ms1_frames:
                if fid not in decoded:
                    continue
                rt, _, _, n_scans = frame_info[fid]
                scans, tofs, intens = decoded[fid]
                if tofs.size == 0:
                    continue
                im_conv = ScanImConverter(im_lo, im_hi, n_scans)
                mz = mz_conv.to_mz(tofs)
                im = im_conv.to_im(scans)
                cmz, cint, cim = fast_centroid(
                    mz, intens.astype(np.float32), im,
                    mz_ppm=cfg.mz_ppm, ims_pct=cfg.ims_pct,
                )
                spectra.append(
                    RawSpectrum(
                        file_id=file_id,
                        ms_level=1,
                        id=f"frame={fid}",
                        precursors=[],
                        centroid=True,
                        scan_start_time=rt / 60.0,
                        total_ion_current=float(cint.sum()),
                        mz=cmz,
                        intensity=cint,
                        mobility=cim,
                    )
                )
        return spectra


def _decode_frame(
    fh, offset: int, compression: int
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Decode one tdf_bin frame block into (scan_ids, tof_indices,
    intensities) arrays."""
    fh.seek(offset)
    header = fh.read(8)
    total_len, num_scans = struct.unpack("<II", header)
    payload = fh.read(total_len - 8)
    if compression == 2:
        raw = _zstd_decompress(payload)
        b = np.frombuffer(raw, dtype=np.uint8)
        # byte-plane unshuffle: [4, n] planes -> little-endian u32
        u32 = np.ascontiguousarray(
            b.reshape(4, -1).T
        ).view(np.uint32).ravel()
    elif compression == 0:
        u32 = np.frombuffer(payload, dtype=np.uint32)
    else:
        raise RuntimeError(
            f"unsupported TimsCompressionType {compression} (only 0 and 2)"
        )
    counts = u32[:num_scans].astype(np.int64)  # per-scan u32 entry counts
    pairs = u32[num_scans:]
    scan_ids = np.repeat(
        np.arange(num_scans, dtype=np.int32), counts // 2
    )
    if pairs.size == 0:
        empty = np.zeros(0, dtype=np.int64)
        return scan_ids[:0], empty, empty.astype(np.float32)
    tof_deltas = pairs[0::2].astype(np.int64)
    intensities = pairs[1::2].astype(np.float32)
    # tof indices are cumulative within each scan
    tof = np.cumsum(tof_deltas)
    # subtract the running total at each scan start to restart the cumsum
    base = np.zeros_like(tof)
    prev_end = 0
    for s, c in enumerate(counts // 2):
        if c == 0:
            continue
        seg = slice(prev_end, prev_end + c)
        base[seg] = tof[prev_end] - tof_deltas[prev_end]
        prev_end += c
    tof = tof - base
    return scan_ids, tof, intensities


def fast_centroid(
    mz: np.ndarray,
    intensity: np.ndarray,
    mobility: np.ndarray,
    mz_ppm: float = 5.0,
    ims_pct: float = 3.0,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Greedy intensity-descending clustering (tdf.rs:305-393): take the
    most intense unclaimed peak, absorb every unclaimed peak within
    mz*(1 +/- ppm*1e-6) and mobility*(1 +/- pct/100), summing intensity;
    the centroid keeps the seed's m/z and mobility. Caps at 10k peaks."""
    order = np.argsort(-intensity, kind="stable")
    mz_s = mz[order]
    int_s = intensity[order]
    im_s = mobility[order]
    claimed = np.zeros(mz_s.shape[0], dtype=bool)
    out_mz, out_int, out_im = [], [], []
    ppm = mz_ppm * 1e-6
    pct = ims_pct / 100.0
    # mass-sorted view for window queries
    mz_order = np.argsort(mz_s, kind="stable")
    mz_sorted = mz_s[mz_order]
    for i in range(mz_s.shape[0]):
        if claimed[i]:
            continue
        if len(out_mz) >= MAX_MS1_PEAKS:
            break
        m, v = mz_s[i], im_s[i]
        lo = np.searchsorted(mz_sorted, m * (1 - ppm), side="left")
        hi = np.searchsorted(mz_sorted, m * (1 + ppm), side="right")
        cand = mz_order[lo:hi]
        cand = cand[~claimed[cand]]
        cand = cand[np.abs(im_s[cand] - v) <= v * pct]
        claimed[cand] = True
        claimed[i] = True
        out_mz.append(m)
        out_int.append(float(int_s[cand].sum()))
        out_im.append(v)
    out = (
        np.asarray(out_mz, dtype=np.float32),
        np.asarray(out_int, dtype=np.float32),
        np.asarray(out_im, dtype=np.float32),
    )
    srt = np.argsort(out[0], kind="stable")
    return out[0][srt], out[1][srt], out[2][srt]
