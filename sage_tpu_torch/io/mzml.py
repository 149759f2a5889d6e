"""Streaming mzML parser.

Parity with crates/sage-cloudpath/src/mzml.rs: a state
machine over PSI-MS controlled-vocabulary accessions. Handles zlib/no
compression, f32/f64 little-endian binary arrays, m/z / intensity / noise
arrays (optional S/N division at a chosen MS level), scan start time units,
selected-ion m/z / charge / intensity, isolation windows, and inverse ion
mobility from either the selected ion or the scan.

Base64 + zlib decode run through the C-backed stdlib; the XML walk uses
the C-accelerated ElementTree iterparse.
"""

from __future__ import annotations

import base64
import gzip
import io
import zlib
from typing import List, Optional

import numpy as np

from ..chem.mass import Tolerance
from ..spectrum.processor import Precursor, RawSpectrum

# CV accessions (mzml.rs:33-63)
ZLIB_COMPRESSION = "MS:1000574"
NO_COMPRESSION = "MS:1000576"
INTENSITY_ARRAY = "MS:1000515"
MZ_ARRAY = "MS:1000514"
NOISE_ARRAY = "MS:1002744"
FLOAT_64 = "MS:1000523"
FLOAT_32 = "MS:1000521"
MS_LEVEL = "MS:1000511"
PROFILE = "MS:1000128"
CENTROID = "MS:1000127"
TOTAL_ION_CURRENT = "MS:1000285"
SCAN_START_TIME = "MS:1000016"
UNIT_SECONDS = "UO:0000010"
UNIT_MINUTES = "UO:0000031"
ION_INJECTION_TIME = "MS:1000927"
SELECTED_ION_MZ = "MS:1000744"
SELECTED_ION_INT = "MS:1000042"
SELECTED_ION_CHARGE = "MS:1000041"
ISO_WINDOW_TARGET = "MS:1000827"
ISO_WINDOW_LOWER = "MS:1000828"
ISO_WINDOW_UPPER = "MS:1000829"
INVERSE_ION_MOBILITY = "MS:1002815"


class MzMLError(ValueError):
    pass


def _localname(tag: str) -> str:
    return tag.rsplit("}", 1)[-1]


class MzMLReader:
    """mzml.rs:65-104."""

    def __init__(
        self,
        file_id: int = 0,
        ms_level: Optional[int] = None,
        signal_to_noise: Optional[int] = None,
    ):
        self.file_id = file_id
        self.ms_level = ms_level
        self.signal_to_noise = signal_to_noise

    def parse(self, source) -> List[RawSpectrum]:
        """Parse an mzML byte stream / bytes / file path into RawSpectrum
        records (mzml.rs:109-403)."""
        import xml.etree.ElementTree as ET

        if isinstance(source, (bytes, bytearray)):
            source = io.BytesIO(bytes(source))
        elif isinstance(source, str):
            source = open(source, "rb")

        spectra: List[RawSpectrum] = []
        spectrum = RawSpectrum(file_id=self.file_id)
        skip_spectrum = False
        precursor = Precursor()
        iso_lo: Optional[float] = None
        iso_hi: Optional[float] = None
        noise_array = np.zeros(0, np.float32)

        # Binary array state
        compression = False
        dtype_f64 = True
        binary_kind: Optional[str] = None

        # Element stack of local names, for cvParam context
        stack: List[str] = []

        for event, elem in ET.iterparse(source, events=("start", "end")):
            name = _localname(elem.tag)
            if event == "start":
                stack.append(name)
                if name == "spectrum":
                    spectrum = RawSpectrum(file_id=self.file_id)
                    spectrum.id = elem.get("id", "")
                    skip_spectrum = False
                    precursor = Precursor()
                    iso_lo = iso_hi = None
                    noise_array = np.zeros(0, np.float32)
                elif name == "precursor":
                    ref = elem.get("spectrumRef")
                    if ref is not None:
                        precursor.spectrum_ref = ref
                continue

            # event == "end"
            stack.pop()
            parent = stack[-1] if stack else ""
            if name == "cvParam" and not skip_spectrum:
                acc = elem.get("accession", "")
                value = elem.get("value")
                if parent == "binaryDataArray":
                    if acc == ZLIB_COMPRESSION:
                        compression = True
                    elif acc == NO_COMPRESSION:
                        compression = False
                    elif acc == FLOAT_64:
                        dtype_f64 = True
                    elif acc == FLOAT_32:
                        dtype_f64 = False
                    elif acc == INTENSITY_ARRAY:
                        binary_kind = "intensity"
                    elif acc == MZ_ARRAY:
                        binary_kind = "mz"
                    elif acc == NOISE_ARRAY:
                        binary_kind = "noise"
                    else:
                        # Unknown CV array type — skip its contents
                        binary_kind = None
                elif parent == "spectrum":
                    if acc == MS_LEVEL:
                        level = int(value)
                        if self.ms_level is not None and level != self.ms_level:
                            skip_spectrum = True
                        spectrum.ms_level = level
                    elif acc == PROFILE:
                        spectrum.centroid = False
                    elif acc == CENTROID:
                        spectrum.centroid = True
                    elif acc == TOTAL_ION_CURRENT:
                        tic = float(value)
                        if tic == 0.0:
                            # No ion current — drop this spectrum entirely
                            skip_spectrum = True
                        else:
                            spectrum.total_ion_current = tic
                elif parent == "isolationWindow":
                    if acc == ISO_WINDOW_TARGET:
                        if precursor.mz == 0.0:
                            precursor.mz = float(value)
                    elif acc == ISO_WINDOW_LOWER:
                        iso_lo = float(value)
                    elif acc == ISO_WINDOW_UPPER:
                        iso_hi = float(value)
                elif parent == "selectedIon":
                    if acc == SELECTED_ION_CHARGE:
                        precursor.charge = int(value)
                    elif acc == SELECTED_ION_MZ:
                        v = float(value)
                        if v != 0.0:
                            precursor.mz = v
                    elif acc == SELECTED_ION_INT:
                        precursor.intensity = float(value)
                    elif acc == INVERSE_ION_MOBILITY:
                        precursor.inverse_ion_mobility = float(value)
                elif parent == "scan":
                    if acc == SCAN_START_TIME:
                        t = float(value)
                        unit = elem.get("unitAccession", "")
                        if unit == UNIT_SECONDS:
                            spectrum.scan_start_time = t / 60.0
                        elif unit == UNIT_MINUTES:
                            spectrum.scan_start_time = t
                        else:
                            raise MzMLError("malformed MzML: unknown scan time unit")
                    elif acc == ION_INJECTION_TIME:
                        spectrum.ion_injection_time = float(value)
                    elif acc == INVERSE_ION_MOBILITY:
                        precursor.inverse_ion_mobility = float(value)
            elif name == "binary" and not skip_spectrum:
                raw = (elem.text or "").strip()
                if raw and binary_kind is not None:
                    decoded = base64.b64decode(raw)
                    if compression:
                        decoded = zlib.decompress(decoded)
                    if dtype_f64:
                        array = np.frombuffer(decoded, dtype="<f8").astype(np.float32)
                    else:
                        n = len(decoded) - (len(decoded) % 4)
                        array = np.frombuffer(decoded[:n], dtype="<f4").copy()
                    if binary_kind == "intensity":
                        spectrum.intensity = array
                    elif binary_kind == "mz":
                        spectrum.mz = array
                    elif binary_kind == "noise":
                        noise_array = array
                binary_kind = None
            elif name == "precursor":
                if precursor.mz != 0.0:
                    if iso_lo is not None and iso_hi is not None:
                        precursor.isolation_window = Tolerance("da", -iso_lo, iso_hi)
                    spectrum.precursors.append(precursor)
                precursor = Precursor()
                iso_lo = iso_hi = None
            elif name == "spectrum":
                allow = not skip_spectrum and (
                    self.ms_level is None or self.ms_level == spectrum.ms_level
                )
                if allow:
                    if (
                        self.signal_to_noise is not None
                        and self.signal_to_noise == spectrum.ms_level
                        and noise_array.size > 0
                    ):
                        n = min(len(spectrum.intensity), len(noise_array))
                        spectrum.intensity = spectrum.intensity.copy()
                        spectrum.intensity[:n] = spectrum.intensity[:n] / noise_array[:n]
                    spectra.append(spectrum)
                spectrum = RawSpectrum(file_id=self.file_id)
            elem.clear()

        return spectra


def _decode_binary_c(lib, fptr, data, off, length, is_zlib, is_f64):
    """base64 -> (zlib) -> f32 via the native decoder; None on failure.
    ``lib``/``fptr`` are hoisted by the caller (per-call ctypes lookups
    cost more than the decode for small arrays)."""
    if length == 0:
        return np.zeros(0, np.float32)
    cap = max((length * 3) // 4, 1024)
    for _ in range(4):
        out = np.empty(cap, np.float32)
        n = lib.mzml_decode_binary(
            data, off, length, int(is_zlib), int(is_f64),
            fptr(out), cap,
        )
        if n >= 0:
            # copy so the (possibly over-sized) scratch buffer is freed
            return out[:n].copy()
        if n == -2:
            cap *= 4
            continue
        return None
    return None


def parse_fast(
    data: bytes,
    file_id: int = 0,
    signal_to_noise: Optional[int] = None,
    ms_level: Optional[int] = None,
) -> Optional[List[RawSpectrum]]:
    """C fast path: the native single-pass scanner (native/mzml_scan.c)
    extracts the XML structure ~5-10x faster than the event walk; this
    wrapper applies exactly the Python parser's semantics (unit
    conversion, TIC==0 skip, S/N division, precursor assembly) and
    decodes binary payloads via the C-backed stdlib. Returns None when
    the native library is unavailable or the scanner bailed."""
    import ctypes

    from ..native import _load, mzml_scan

    recs = mzml_scan(data)
    if recs is None:
        return None
    lib = _load()
    has_c_decode = bool(lib) and hasattr(lib, "mzml_decode_binary")

    def fptr(a):
        return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))

    spectra: List[RawSpectrum] = []
    for r in recs:
        if r["skip"]:
            continue
        level = int(r["ms_level"])
        if ms_level is not None and level != ms_level:
            continue
        if r["sst_unit"] == -1:
            raise MzMLError("malformed MzML: unknown scan time unit")
        sst = float(r["sst"]) / 60.0 if r["sst_unit"] == 1 else float(r["sst"])
        precursors: List[Precursor] = []
        for pi in range(int(r["n_prec"])):
            iso = None
            if r["p_has_lo"][pi] and r["p_has_hi"][pi]:
                iso = Tolerance(
                    "da", -float(r["p_iso_lo"][pi]), float(r["p_iso_hi"][pi])
                )
            ref = None
            if r["p_ref_len"][pi]:
                ref = data[
                    int(r["p_ref_off"][pi]) : int(r["p_ref_off"][pi])
                    + int(r["p_ref_len"][pi])
                ].decode()
            precursors.append(
                Precursor(
                    mz=float(r["p_mz"][pi]),
                    intensity=(
                        float(r["p_int"][pi]) if r["p_has_int"][pi] else None
                    ),
                    charge=(
                        int(r["p_charge"][pi])
                        if r["p_charge"][pi] >= 0
                        else None
                    ),
                    spectrum_ref=ref,
                    isolation_window=iso,
                    inverse_ion_mobility=(
                        float(r["p_im"][pi]) if r["p_has_im"][pi] else None
                    ),
                )
            )
        mz = np.zeros(0, np.float32)
        intensity = np.zeros(0, np.float32)
        noise = np.zeros(0, np.float32)
        for ai in range(int(r["n_arr"])):
            alen = int(r["a_len"][ai])
            aoff = int(r["a_off"][ai])
            arr = None
            if has_c_decode:
                arr = _decode_binary_c(
                    lib, fptr, data, aoff, alen,
                    bool(r["a_zlib"][ai]), bool(r["a_f64"][ai]),
                )
            if arr is None:  # C decode failed: stdlib path
                raw = data[aoff : aoff + alen].strip()
                if not raw:
                    continue
                decoded = base64.b64decode(raw)
                if r["a_zlib"][ai]:
                    decoded = zlib.decompress(decoded)
                if r["a_f64"][ai]:
                    arr = np.frombuffer(decoded, dtype="<f8").astype(np.float32)
                else:
                    nb = len(decoded) - (len(decoded) % 4)
                    arr = np.frombuffer(decoded[:nb], dtype="<f4").copy()
            kind = int(r["a_kind"][ai])
            if kind == 0:
                mz = arr
            elif kind == 1:
                intensity = arr
            elif kind == 2:
                noise = arr
        if (
            signal_to_noise is not None
            and signal_to_noise == level
            and noise.size > 0
        ):
            n = min(len(intensity), len(noise))
            intensity = intensity.copy()
            intensity[:n] = intensity[:n] / noise[:n]
        spectra.append(
            RawSpectrum(
                file_id=file_id,
                ms_level=level,
                id=data[
                    int(r["id_off"]) : int(r["id_off"]) + int(r["id_len"])
                ].decode(),
                precursors=precursors,
                centroid=bool(r["centroid"] == 1),
                scan_start_time=sst,
                ion_injection_time=float(r["iit"]),
                total_ion_current=float(r["tic"]),
                mz=mz,
                intensity=intensity,
            )
        )
    return spectra


def _parse_bytes(
    data: bytes,
    file_id: int = 0,
    signal_to_noise: Optional[int] = None,
    ms_level: Optional[int] = None,
) -> List[RawSpectrum]:
    fast = parse_fast(
        data, file_id=file_id, signal_to_noise=signal_to_noise,
        ms_level=ms_level,
    )
    if fast is not None:
        return fast
    reader = MzMLReader(
        file_id=file_id, ms_level=ms_level, signal_to_noise=signal_to_noise
    )
    return reader.parse(data)


def read_mzml(
    path: str,
    file_id: int = 0,
    signal_to_noise: Optional[int] = None,
    ms_level: Optional[int] = None,
) -> List[RawSpectrum]:
    """Read an mzML (or .mzML.gz) file from local disk; prefers the C
    fast-path scanner with the Python state machine as fallback. Files
    too large to hold in memory stream through the Python parser."""
    import os as _os

    # 2 GiB of XML: above this, skip the whole-document C scanner and
    # stream (bounded memory; gz sizes are pre-decompression so the cap
    # is conservative)
    STREAM_ABOVE = 2 << 30
    try:
        big = _os.path.getsize(path) > (
            STREAM_ABOVE // 4 if path.lower().endswith(".gz") else STREAM_ABOVE
        )
    except OSError:
        big = False
    reader_kwargs = dict(
        file_id=file_id, ms_level=ms_level, signal_to_noise=signal_to_noise
    )
    if path.lower().endswith(".gz"):
        with gzip.open(path, "rb") as fh:
            if big:
                return MzMLReader(**reader_kwargs).parse(fh)
            data = fh.read()
    else:
        with open(path, "rb") as fh:
            if big:
                return MzMLReader(**reader_kwargs).parse(fh)
            data = fh.read()
    return _parse_bytes(data, **reader_kwargs)


def _parse_chunk(args):
    """Worker: parse one byte range of <spectrum> blocks (module-level so
    it pickles into a process pool)."""
    chunk, file_id, signal_to_noise, ms_level = args
    return _parse_bytes(
        b"<mzML>" + chunk + b"</mzML>", file_id=file_id,
        signal_to_noise=signal_to_noise, ms_level=ms_level,
    )


def read_mzml_parallel(
    path: str,
    file_id: int = 0,
    signal_to_noise: Optional[int] = None,
    ms_level: Optional[int] = None,
    workers: Optional[int] = None,
) -> List[RawSpectrum]:
    """Within-file parallel mzML reading: split the document at
    ``<spectrum>`` boundaries and parse the ranges across a process pool.

    The reference parallelizes across files with rayon (util.rs:15-29);
    a host feeding a >30k spectra/s device needs within-file
    parallelism too, since the XML event walk is the bottleneck
    (~12k spectra/s single-core). Falls back to the serial parser on
    small files or single-core hosts; results are identical (each chunk
    runs the same state machine)."""
    import os as _os
    import re as _re

    # the cores this process may run on (a container's share of a larger
    # host's), half of them: one spawned worker each
    cores = (len(_os.sched_getaffinity(0)) if hasattr(_os, "sched_getaffinity")
             else _os.cpu_count() or 1)
    n_workers = workers or max(cores // 2, 1)
    if path.lower().endswith(".gz"):
        with gzip.open(path, "rb") as fh:
            data = fh.read()
    else:
        with open(path, "rb") as fh:
            data = fh.read()
    if n_workers <= 1 or len(data) < (8 << 20):
        return _parse_bytes(
            data, file_id=file_id, signal_to_noise=signal_to_noise,
            ms_level=ms_level,
        )
    starts = [m.start() for m in _re.finditer(b"<spectrum[ >]", data)]
    end = data.rfind(b"</spectrumList>")
    if not starts or end < 0:
        return _parse_bytes(
            data, file_id=file_id, signal_to_noise=signal_to_noise,
            ms_level=ms_level,
        )
    K = min(max(n_workers * 2, 1), len(starts))
    bounds = [starts[i * len(starts) // K] for i in range(K)] + [end]
    chunks = [
        (data[bounds[i] : bounds[i + 1]], file_id, signal_to_noise, ms_level)
        for i in range(K)
    ]
    import multiprocessing
    from concurrent.futures import ProcessPoolExecutor

    # spawned workers: the caller may hold CUDA state and threads, which
    # a forked child must not inherit
    out: List[RawSpectrum] = []
    with ProcessPoolExecutor(
        max_workers=n_workers, mp_context=multiprocessing.get_context("spawn")
    ) as ex:
        for r in ex.map(_parse_chunk, chunks):
            out.extend(r)
    return out
