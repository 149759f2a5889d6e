"""A batch's prep as columns, and its two costly steps on the card: the
CUDA kernel's wrapper and its plain PyTorch version.

:class:`BatchColumns` reads a batch of ProcessedSpectrum objects once
into flat columns: the peaks concatenated with their lengths and
offsets, the first precursor's m/z and charge, and the per-spectrum
metadata that the feature table reports (rt, TIC, ion mobility, file
id, spectrum id). The host's padded [S, Pk] peaks are built from the
flat peaks only where a path reads them (:func:`pad_flat`, counted by
the recorder's ``search.host_pad`` counter, ``utils/trace.py``).

:func:`batch_prep` does the rest of the narrow batch's prep in one
launch: it scatters the flat peaks into the device's padded block
[2, S, Pk] (masses with +inf pads, intensities with -1 pads, what
``Scorer._pad_peaks`` builds on the host) and binary-searches each
query row's precursor-window bounds in the mass-sorted peptide table
(left-sided for the low bound, right-sided for the high one, over the
table's real entries), which gives ``np.searchsorted``'s i0 and i1
(``Scorer._expand_rows``). No TPU kernel corresponds: the JAX package
does both on the host. A CUDA tensor goes to the kernel
(``csrc/batch_prep.cu``), a CPU tensor to the plain version.
``launches`` counts kernel launches, as does the recorder's
``launch.batch_prep`` counter.
"""

from __future__ import annotations

import ctypes
from operator import attrgetter
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from ..utils import trace

launches = 0


def padded_width(lens: np.ndarray) -> int:
    """The padded peak axis: the longest spectrum (at least 1), rounded
    up to a multiple of 32."""
    Pk = int(max(lens.max() if lens.size else 1, 1))
    return -(-Pk // 32) * 32


def pad_flat(masses: np.ndarray, intens: np.ndarray, lens: np.ndarray,
             Pk: int) -> Tuple[np.ndarray, np.ndarray]:
    """The host's padded peaks [S, Pk] from flat ones: masses with +inf
    pads, intensities with -1 pads. Counted as ``search.host_pad``."""
    trace.count("search.host_pad")
    S = lens.size
    pm = np.full((S, Pk), np.inf, dtype=np.float32)
    pi = np.full((S, Pk), -1.0, dtype=np.float32)
    if S:
        rows = np.repeat(np.arange(S), lens)
        offs = np.concatenate([[0], np.cumsum(lens)[:-1]])
        cols = np.arange(int(lens.sum())) - np.repeat(offs, lens)
        pm[rows, cols] = masses
        pi[rows, cols] = intens
    return pm, pi


def _column(objs, name: str, dtype) -> np.ndarray:
    """Attribute ``name`` of every object, as one array of ``dtype``."""
    return np.fromiter(map(attrgetter(name), objs), dtype=dtype,
                       count=len(objs))


class BatchColumns:
    """One batch of ProcessedSpectrum objects, read once into columns.

    Per spectrum: ``ids``, ``prec_mz`` (f32 m/z of the first precursor),
    ``prec_z`` (i32 charge, 0 where the file gives none), ``rt``,
    ``tic``, ``ims`` (f32, 0 where absent), ``file_id`` (i32), and the
    peaks' ``lens`` and ``offs`` (i64, [S + 1]). ``Pk`` is the padded
    peak axis. The flat peaks (``flat_masses``, ``flat_intens``, f32
    [N]) are concatenated on first use, or into the caller's buffers
    (:meth:`flatten_into`); ``masses`` and ``intens`` are the host's
    padded [S, Pk] arrays, built from them on first read."""

    def __init__(self, spectra: Sequence):
        S = len(spectra)
        try:
            precs = [s.precursors[0] for s in spectra]
        except (IndexError, TypeError):
            bad = next(s for s in spectra if not s.precursors)
            raise ValueError(f"missing MS1 precursor for {bad.id}") from None
        self.ids = list(map(attrgetter("id"), spectra))
        self.prec_mz = _column(precs, "mz", np.float32)
        self.prec_z = np.fromiter((p.charge or 0 for p in precs),
                                  dtype=np.int32, count=S)
        self.rt = _column(spectra, "scan_start_time", np.float32)
        self.tic = _column(spectra, "total_ion_current", np.float32)
        self.ims = np.fromiter((p.inverse_ion_mobility or 0.0 for p in precs),
                               dtype=np.float32, count=S)
        self.file_id = _column(spectra, "file_id", np.int32)
        self._parts = (list(map(attrgetter("masses"), spectra)),
                       list(map(attrgetter("intensities"), spectra)))
        self.lens = np.fromiter(map(len, self._parts[0]), dtype=np.int64,
                                count=S)
        self.offs = np.zeros(S + 1, dtype=np.int64)
        np.cumsum(self.lens, out=self.offs[1:])
        self.n_peaks = int(self.offs[-1])
        self.Pk = padded_width(self.lens)
        self.flat_masses: Optional[np.ndarray] = None
        self.flat_intens: Optional[np.ndarray] = None
        self._padded: Optional[Tuple[np.ndarray, np.ndarray]] = None

    def __len__(self) -> int:
        return self.lens.size

    def flatten_into(self, masses: np.ndarray, intens: np.ndarray) -> None:
        """Concatenate the peaks into the f32 [N] buffers given, which
        then hold the flat columns."""
        if self.lens.size:
            np.concatenate(self._parts[0], out=masses)
            np.concatenate(self._parts[1], out=intens)
        self.flat_masses, self.flat_intens = masses, intens
        self._parts = None

    def _flat(self) -> None:
        if self.flat_masses is None:
            self.flatten_into(np.empty(self.n_peaks, np.float32),
                              np.empty(self.n_peaks, np.float32))

    def padded(self) -> Tuple[np.ndarray, np.ndarray]:
        if self._padded is None:
            self._flat()
            self._padded = pad_flat(self.flat_masses, self.flat_intens,
                                    self.lens, self.Pk)
        return self._padded

    @property
    def masses(self) -> np.ndarray:
        return self.padded()[0]

    @property
    def intens(self) -> np.ndarray:
        return self.padded()[1]


def _bind():
    from ._cuda_build import load

    lib = load("batch_prep")
    fn = lib.batch_prep
    if fn.argtypes is None:
        c_int, c_ptr = ctypes.c_int, ctypes.c_void_p
        fn.argtypes = ([c_ptr] * 3 + [c_int] * 2 + [c_ptr] * 2 + [c_int]
                       + [c_ptr, c_int] + [c_ptr] * 3)
        fn.restype = c_int
    return lib


def batch_prep(masses, intens, offs, lo, hi, mono, *, P: int, Pk: int):
    """Pad a batch's flat peaks and search its query rows' windows.

    masses, intens: f32 [N] flat peaks; offs: i32 [S + 1] each
    spectrum's first peak (``offs[S] == N``, no spectrum longer than
    Pk); lo, hi: f32 [R] the rows' precursor-window bounds; mono: f32
    [>= P] the ascending peptide masses, of which the first P are
    searched. Returns (peaks f32 [2, S, Pk], i01 i32 [2, R]): i01[0] the
    count of masses below lo, i01[1] the count at or below hi (a NaN
    bound counts every mass, as numpy orders NaN last)."""
    global launches
    if mono.device.type == "cpu":
        return batch_prep_plain(masses, intens, offs, lo, hi, mono, P=P,
                                Pk=Pk)
    if mono.device.type != "cuda":
        raise ValueError(f"batch_prep: unsupported device {mono.device}")
    ts = (masses, intens, offs, lo, hi, mono)
    S, N, R = offs.numel() - 1, masses.numel(), lo.numel()
    checks = (
        (all(t.device == mono.device for t in ts),
         "tensors must share one device"),
        (all(t.is_contiguous() for t in ts), "tensors must be contiguous"),
        (offs.dtype == torch.int32
         and all(t.dtype == torch.float32 for t in ts if t is not offs),
         "dtypes must be f32 but offs i32"),
        (intens.numel() == N and hi.numel() == R and S >= 1,
         f"bad shapes N={N} R={R} S={S}"),
        (0 <= P <= mono.numel() and 1 <= Pk and N < (1 << 31)
         and R < (1 << 30), f"bad sizes P={P} Pk={Pk} N={N} R={R}"),
    )
    for ok, msg in checks:
        if not ok:
            raise ValueError(f"batch_prep: {msg}")
    lib = _bind()
    peaks = torch.empty((2, S, Pk), dtype=torch.float32, device=mono.device)
    i01 = torch.empty((2, R), dtype=torch.int32, device=mono.device)
    with torch.cuda.device(mono.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.batch_prep(
            masses.data_ptr(), intens.data_ptr(), offs.data_ptr(), S, Pk,
            lo.data_ptr(), hi.data_ptr(), R, mono.data_ptr(), P,
            peaks.data_ptr(), i01.data_ptr(), stream,
        )
    if rc != 0:
        raise RuntimeError(f"batch_prep launch failed: CUDA error {rc}")
    launches += 1
    trace.count("launch.batch_prep")
    return peaks, i01


def batch_prep_plain(masses, intens, offs, lo, hi, mono, *, P: int,
                     Pk: int):
    """The plain PyTorch version of :func:`batch_prep`: an indexed
    scatter and two ``torch.searchsorted`` calls."""
    dev = mono.device
    S = offs.numel() - 1
    o = offs.long()
    lens = o[1:] - o[:-1]
    peaks = torch.empty((2, S, Pk), dtype=torch.float32, device=dev)
    peaks[0] = float("inf")
    peaks[1] = -1.0
    rows = torch.repeat_interleave(torch.arange(S, device=dev), lens)
    cols = (torch.arange(masses.numel(), device=dev)
            - torch.repeat_interleave(o[:-1], lens))
    peaks[0, rows, cols] = masses
    peaks[1, rows, cols] = intens
    table = mono[:P].contiguous()
    i0 = torch.searchsorted(table, lo, side="left")
    i1 = torch.searchsorted(table, hi, side="right")
    i0 = torch.where(torch.isnan(lo), P, i0)
    i1 = torch.where(torch.isnan(hi), P, i1)
    return peaks, torch.stack([i0, i1]).to(torch.int32)
