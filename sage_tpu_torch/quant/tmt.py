"""Isobaric (TMT) reporter-ion quantification.

Reference: crates/sage/src/tmt.rs — for each spectrum at the configured
MS level, pick the most intense peak within tolerance of each label m/z
(with a -PROTON window offset for parity with ProteomeDiscoverer /
FragPipe); label tables for TMT 6/10/11/16/18 plus user-defined masses.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Union

import numpy as np

from ..chem.mass import PROTON, Tolerance
from ..spectrum.processor import ProcessedSpectrum, select_most_intense_peak

TMT6PLEX = np.array(
    [126.127726, 127.124761, 128.134436, 129.131471, 130.141145, 131.138180],
    dtype=np.float32,
)

TMT11PLEX = np.array(
    [
        126.127726, 127.124761, 127.131081, 128.128116, 128.134436, 129.131471,
        129.137790, 130.134825, 130.141145, 131.138180, 131.144499,
    ],
    dtype=np.float32,
)

TMT18PLEX = np.array(
    [
        126.127726, 127.124761, 127.131081, 128.128116, 128.134436, 129.131471,
        129.137790, 130.134825, 130.141145, 131.138180, 131.144500, 132.141535,
        132.147855, 133.144890, 133.151210, 134.148245, 134.154565, 135.15160,
    ],
    dtype=np.float32,
)


@dataclasses.dataclass
class Isobaric:
    """tmt.rs:14-62. ``kind`` is one of Tmt6/Tmt10/Tmt11/Tmt16/Tmt18/User."""

    kind: str
    user_masses: Optional[List[float]] = None

    @staticmethod
    def from_json(v: Union[str, List[float]]) -> "Isobaric":
        if isinstance(v, list):
            return Isobaric("User", [float(x) for x in v])
        return Isobaric(str(v))

    def reporter_masses(self) -> np.ndarray:
        k = self.kind
        if k == "Tmt6":
            return TMT6PLEX
        if k == "Tmt10":
            return TMT11PLEX[:10]
        if k == "Tmt11":
            return TMT11PLEX
        if k == "Tmt16":
            return TMT18PLEX[:16]
        if k == "Tmt18":
            return TMT18PLEX
        return np.asarray(self.user_masses or [], dtype=np.float32)

    def modification_mass(self) -> Optional[float]:
        if self.kind in ("Tmt6", "Tmt10", "Tmt11"):
            return 229.162932
        if self.kind == "Tmt16":
            return 304.2071
        if self.kind == "Tmt18":
            return 304.2135
        return None

    def headers(self) -> List[str]:
        n = len(self.reporter_masses())
        prefix = "user" if self.kind == "User" else "tmt"
        return [f"{prefix}_{i + 1}" for i in range(n)]


@dataclasses.dataclass
class TmtQuant:
    """tmt.rs:299-305."""

    spec_id: str
    file_id: int
    ion_injection_time: float
    peaks: List[float]


def find_reporter_ions(
    masses: np.ndarray,
    intensities: np.ndarray,
    labels: np.ndarray,
    label_tolerance: Tolerance,
) -> List[Optional[float]]:
    """tmt.rs:193-212: most intense peak near each label m/z; the window
    shifts by -PROTON because processed peaks store neutral masses."""
    out: List[Optional[float]] = []
    for label in labels:
        idx = select_most_intense_peak(
            masses, intensities, np.float32(label), label_tolerance, offset=-float(PROTON)
        )
        out.append(float(intensities[idx]) if idx is not None else None)
    return out


def quantify(
    spectra: Sequence[ProcessedSpectrum],
    isobaric_labels: Isobaric,
    isobaric_tolerance: Tolerance,
    level: int,
) -> List[TmtQuant]:
    """tmt.rs:314-352: extract reporter ions from every spectrum at the
    configured MS level; MS3 spectra link back via precursor spectrum_ref."""
    labels = isobaric_labels.reporter_masses()
    out: List[TmtQuant] = []
    for spectrum in spectra:
        if spectrum.level != level:
            continue
        if level == 1:
            continue
        if level == 2:
            spec_id = spectrum.id
        else:
            spec_id = ""
            if spectrum.precursors and spectrum.precursors[0].spectrum_ref:
                spec_id = spectrum.precursors[0].spectrum_ref
        peaks = [
            p if p is not None else 0.0
            for p in find_reporter_ions(
                spectrum.masses, spectrum.intensities, labels, isobaric_tolerance
            )
        ]
        out.append(
            TmtQuant(
                spec_id=spec_id,
                file_id=spectrum.file_id,
                ion_injection_time=spectrum.ion_injection_time,
                peaks=peaks,
            )
        )
    return out
