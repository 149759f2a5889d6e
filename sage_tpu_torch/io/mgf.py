"""MGF (Mascot Generic Format) parser.

Parity with crates/sage-cloudpath/src/mgf.rs: global
embedded defaults (TOL/TOLU/CHARGE) before the first BEGIN IONS block,
then per-query blocks with TITLE/PEPMASS/CHARGE/TOL/TOLU/RTINSECONDS and
numeric peak lines. A charge list ("2+ and 3+") produces one Precursor
per charge (mgf.rs:86-104); TOL/TOLU become the precursor isolation
window (Da/ppm, symmetric ±|tol|, mgf.rs:72-84). Spectra are MS2 and
centroided by default (mgf.rs:106-113); peaks without an intensity get
1.0 (mgf.rs:295-298); malformed blocks (no id / no precursor / no peaks /
length mismatch) are skipped with a warning (mgf.rs:116-127).
"""

from __future__ import annotations

import gzip
import logging
import re
from typing import List, Optional

import numpy as np

from ..chem.mass import Tolerance
from ..spectrum.processor import Precursor, RawSpectrum

log = logging.getLogger("sage_tpu_torch")

_CHARGE_RE = re.compile(r"(\d)\+?")


def _parse_charges(value: str) -> List[int]:
    # mgf.rs:168-181: every single digit (optionally followed by '+')
    return [int(m.group(0)[0]) for m in _CHARGE_RE.finditer(value)]


def _isolation_window(tol: Optional[float], unit: Optional[str]) -> Optional[Tolerance]:
    # mgf.rs:72-84
    if tol is None or unit is None:
        return None
    if unit == "Da":
        return Tolerance("da", -abs(tol), abs(tol))
    if unit == "ppm":
        return Tolerance("ppm", -abs(tol), abs(tol))
    return None


class _Query:
    __slots__ = (
        "id", "precursors", "tol", "tol_unit", "charges", "rt_minutes",
        "mz", "intensity",
    )

    def __init__(self, tol, tol_unit, charges):
        self.id = ""
        self.precursors: List[Precursor] = []
        self.tol = tol
        self.tol_unit = tol_unit
        self.charges = charges
        self.rt_minutes: Optional[float] = None
        self.mz: List[float] = []
        self.intensity: List[float] = []


# a peak region is clean for the bulk path iff every line starts with a
# digit (the exact parser treats any other line as a header/ignored line)
_NONPEAK_LINE_RE = re.compile(r"^[ \t]*[^\d\s]", re.MULTILINE)


def _find_line_start(contents: str, token: str, pos: int) -> int:
    """Index of the next occurrence of ``token`` at a line start (modulo
    leading spaces/tabs), or -1. Mirrors the exact parser's
    line.strip().startswith(token) dispatch without materializing lines."""
    while True:
        p = contents.find(token, pos)
        if p < 0:
            return -1
        nl = contents.rfind("\n", 0, p)
        if not contents[nl + 1 : p].strip(" \t"):
            return p
        pos = p + 1


def _fast_precursors(precursors_raw, charges, iso) -> List[Precursor]:
    """Precursor expansion for the bulk path — same semantics as the
    exact parser's ``finish`` (mgf.rs:86-104)."""
    precursors: List[Precursor] = []
    for pmz, pint in precursors_raw:
        if charges:
            for z in charges:
                precursors.append(
                    Precursor(mz=pmz, intensity=pint, charge=z,
                              isolation_window=iso)
                )
        else:
            precursors.append(
                Precursor(mz=pmz, intensity=pint, isolation_window=iso)
            )
    return precursors


def _parse_mgf_fast(contents: str, file_id: int) -> Optional[List[RawSpectrum]]:
    """Bulk-numpy MGF parser: one C-level split + one array parse per
    query block instead of a Python loop per peak line (~10x on typical
    uniform files). Returns None when the file's structure needs the
    exact line-by-line parser (interleaved headers after peaks, blank or
    malformed peak lines, ragged columns) — the caller falls back, so
    this path never has to reproduce the exact parser's error handling,
    only its results on well-formed input."""
    import warnings

    from ..native import seq_f32_sum_rows

    if "\r" in contents:
        contents = contents.replace("\r\n", "\n").replace("\r", "\n")
    begin = _find_line_start(contents, "BEGIN IONS", 0)
    if begin < 0:
        return []
    # embedded global parameters before the first BEGIN IONS
    default_tol: Optional[float] = None
    default_tol_unit: Optional[str] = None
    default_charges: Optional[List[int]] = None
    for line in contents[:begin].splitlines():
        line = line.strip()
        if line.startswith("TOL="):
            try:
                default_tol = float(line[4:])
            except ValueError:
                pass
        elif line.startswith("TOLU="):
            default_tol_unit = line[5:]
        elif line.startswith("CHARGE="):
            default_charges = _parse_charges(line[7:])

    pending = []  # (qid, precursors, rt, mz32, int32) awaiting batched TIC
    cur = begin + len("BEGIN IONS")
    while True:
        end = _find_line_start(contents, "END IONS", cur)
        if end < 0:
            break  # trailing content never reaches finish() — dropped
        block = contents[cur:end]
        nl = contents.find("\n", end)
        cur = len(contents) if nl < 0 else nl + 1

        m = re.search(r"^[ \t]*\d", block, re.MULTILINE)
        if m is None:
            return None  # block with no peak lines: exact path warns
        headers, region = block[: m.start()], block[m.start() :]
        region = region.strip()
        if "\n\n" in region:
            return None  # blank line inside the peak list
        # every interior peak line must start with a digit (the exact
        # parser routes any other line to the header dispatch; it would
        # also accept e.g. "+1.5" or "nan" that np.fromstring parses)
        n = region.count("\n") + 1
        if _NONPEAK_LINE_RE.search(region):
            return None  # header after peaks / malformed peak line
        qid = ""
        precursors_raw: List[tuple] = []
        charges = default_charges
        tol, tol_unit = default_tol, default_tol_unit
        rt_minutes: Optional[float] = None
        for line in headers.split("\n"):
            line = line.strip()
            if not line or line.startswith("BEGIN IONS"):
                continue
            if line.startswith("TITLE="):
                qid = line[6:]
            elif line.startswith("PEPMASS="):
                parts = line[8:].split()
                if not parts:
                    precursors_raw.append((0.0, None))
                    continue
                try:
                    pmz = float(np.float32(parts[0]))
                except ValueError:
                    return None  # exact path warns + keeps scanning
                pint = None
                if len(parts) > 1:
                    try:
                        pint = float(np.float32(parts[1]))
                    except ValueError:
                        pass
                precursors_raw.append((pmz, pint))
            elif line.startswith("CHARGE="):
                charges = _parse_charges(line[7:])
            elif line.startswith("TOL="):
                try:
                    tol = float(line[4:])
                except ValueError:
                    pass
            elif line.startswith("TOLU="):
                tol_unit = line[5:]
            elif line.startswith("RTINSECONDS="):
                try:
                    rt_minutes = float(np.float32(line[12:])) / 60.0
                except ValueError:
                    pass
            # unknown headers are ignored, like the exact parser

        # uniform-column bulk parse: width from the first line, verified
        # against the last line and the exact total count (mixed-width
        # lines aliasing as uniform would need first AND last lines of
        # the alias width AND a matching total — and np.fromstring stops
        # at the first unparseable token, so junk shows up as a short
        # array). Anything irregular falls back to the exact parser.
        first_c = len(region[: region.find("\n")].split()) if n > 1 else len(region.split())
        if n > 1 and len(region[region.rfind("\n") + 1 :].split()) != first_c:
            return None  # ragged columns
        if first_c < 1:
            return None
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", DeprecationWarning)
            vals = np.fromstring(region, dtype=np.float64, sep=" ")
        if vals.size != first_c * n:
            return None  # unparseable token or ragged interior line
        if first_c == 1:
            mz32 = vals.astype(np.float32)
            int32 = np.ones(n, np.float32)
        else:
            vals = vals.reshape(n, first_c)  # cols past 2 are ignored
            mz32 = vals[:, 0].astype(np.float32)
            int32 = np.ascontiguousarray(vals[:, 1]).astype(np.float32)
        iso = _isolation_window(tol, tol_unit)
        precursors = _fast_precursors(precursors_raw, charges, iso)
        if not qid or not precursors or mz32.size == 0:
            log.warning("malformed MGF query block %r skipped", qid)
            continue
        pending.append((qid, precursors, rt_minutes, mz32, int32))

    if not pending:
        return []
    # one batched strictly-sequential f32 TIC pass over all blocks
    maxlen = max(p[3].size for p in pending)
    padded = np.zeros((len(pending), maxlen), np.float32)
    lens = np.empty(len(pending), np.int32)
    for i, (_, _, _, _, it) in enumerate(pending):
        padded[i, : it.size] = it
        lens[i] = it.size
    tics = seq_f32_sum_rows(padded, lens)
    spectra: List[RawSpectrum] = []
    for (qid, precursors, rt_minutes, mz32, int32), tic in zip(pending, tics):
        spectra.append(
            RawSpectrum(
                file_id=file_id,
                ms_level=2,
                centroid=True,
                id=qid,
                precursors=precursors,
                scan_start_time=rt_minutes or 0.0,
                total_ion_current=float(np.float32(tic)),
                mz=mz32,
                intensity=int32,
            )
        )
    return spectra


def parse_mgf(contents: str, file_id: int = 0) -> List[RawSpectrum]:
    """Parse MGF text into RawSpectrum objects (mgf.rs:333-369).

    Tries the bulk-numpy fast path first; any structural surprise falls
    back to the exact line-by-line parser for the whole file."""
    try:
        fast = _parse_mgf_fast(contents, file_id)
    except Exception:  # pragma: no cover - defensive
        log.warning("MGF fast path failed; using exact parser", exc_info=True)
        fast = None
    if fast is not None:
        return fast
    return _parse_mgf_exact(contents, file_id)


def _parse_mgf_exact(contents: str, file_id: int = 0) -> List[RawSpectrum]:
    """Line-by-line reference-shaped parser (the semantics anchor)."""
    default_tol: Optional[float] = None
    default_tol_unit: Optional[str] = None
    default_charges: Optional[List[int]] = None

    lines = iter(contents.splitlines())
    # embedded global parameters until the first BEGIN IONS
    started = False
    for line in lines:
        line = line.strip()
        if line.startswith("BEGIN IONS"):
            started = True
            break
        if line.startswith("TOL="):
            try:
                default_tol = float(line[4:])
            except ValueError:
                pass
        elif line.startswith("TOLU="):
            default_tol_unit = line[5:]
        elif line.startswith("CHARGE="):
            default_charges = _parse_charges(line[7:])
    if not started:
        return []

    spectra: List[RawSpectrum] = []
    q = _Query(default_tol, default_tol_unit, default_charges)

    def finish(q: _Query) -> None:
        iso = _isolation_window(q.tol, q.tol_unit)
        precursors: List[Precursor] = []
        for prec in q.precursors:
            prec.isolation_window = iso
            if q.charges:
                for z in q.charges:
                    precursors.append(
                        Precursor(
                            mz=prec.mz, intensity=prec.intensity, charge=z,
                            isolation_window=iso,
                        )
                    )
            else:
                precursors.append(prec)
        spec = RawSpectrum(
            file_id=file_id,
            ms_level=2,
            centroid=True,
            id=q.id,
            precursors=precursors,
            scan_start_time=q.rt_minutes or 0.0,
            total_ion_current=float(np.float32(sum(np.float32(i) for i in q.intensity))),
            mz=np.asarray(q.mz, dtype=np.float32),
            intensity=np.asarray(q.intensity, dtype=np.float32),
        )
        if (
            not spec.id
            or not spec.precursors
            or spec.mz.size == 0
            or spec.mz.size != spec.intensity.size
        ):
            log.warning("malformed MGF query block %r skipped", q.id)
            return
        spectra.append(spec)

    for line in lines:
        line = line.strip()
        if not line:
            continue
        if line[0].isdigit():
            parts = line.split()
            try:
                q.mz.append(float(parts[0]))
            except ValueError:
                log.warning("malformed MGF peak line %r", line)
                continue
            if len(parts) > 1:
                # mgf.rs:289-295: an unparseable intensity pushes nothing,
                # leaving a length mismatch that voids the block
                try:
                    q.intensity.append(float(parts[1]))
                except ValueError:
                    pass
            else:
                q.intensity.append(1.0)
        elif line.startswith("END IONS"):
            finish(q)
            q = _Query(default_tol, default_tol_unit, default_charges)
        elif line.startswith("TITLE="):
            q.id = line[6:]
        elif line.startswith("PEPMASS="):
            parts = line[8:].split()
            prec = Precursor()
            if parts:
                try:
                    prec.mz = float(np.float32(parts[0]))
                except ValueError:
                    log.warning("malformed PEPMASS line %r", line)
                    continue
            if len(parts) > 1:
                try:
                    prec.intensity = float(np.float32(parts[1]))
                except ValueError:
                    pass
            q.precursors.append(prec)
        elif line.startswith("CHARGE="):
            q.charges = _parse_charges(line[7:])
        elif line.startswith("TOL="):
            try:
                q.tol = float(line[4:])
            except ValueError:
                pass
        elif line.startswith("TOLU="):
            q.tol_unit = line[5:]
        elif line.startswith("RTINSECONDS="):
            try:
                q.rt_minutes = float(np.float32(line[12:])) / 60.0
            except ValueError:
                pass
    return spectra


def read_mgf(path: str, file_id: int = 0) -> List[RawSpectrum]:
    if path.endswith(".gz"):
        with gzip.open(path, "rt") as f:
            contents = f.read()
    else:
        with open(path) as f:
            contents = f.read()
    return parse_mgf(contents, file_id=file_id)
