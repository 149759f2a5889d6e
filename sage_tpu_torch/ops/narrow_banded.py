"""Peak-major banded stage 1 for the narrow search, in PyTorch.

Counterpart of ``sage_tpu/ops/narrow_banded.py``. The candidate-major
stage 1 (``ops/search.py``) compares every candidate fragment against
every peak, O(W x L x Pk) per query row: the right shape for narrow
windows, but a precursor window of a few Da on a proteome-size database
holds thousands of candidates. This is the sparse form for that regime:

1. The flat m/z-sorted fragment index is re-sorted by (peptide band,
   m/z), with fine bands (``SAGE_TPU_NARROW_BAND_W`` peptides, 2048 by
   default), so a narrow precursor window covers one to a few bands. Per
   (peak, fragment charge, covered band) the in-tolerance fragments are a
   contiguous range of the band's segment.
2. The range ends are found on the device by a bounded binary search
   (``_bounded_search``: ``nstep`` steps of gather and compare over
   [spectra, bands, peaks] lanes), with the f32 window bounds of
   ``tol_bounds_static`` (the reference's op order), so the ranges hold
   exactly the fragments the candidate-major compare counts. On the card
   it is one launch of ``csrc/peak_ranges.cu``'s banded form, each
   thread one element, its bounds computed in place.
3. Each spectrum's entries are gathered (``csrc/open_entries.cu``),
   sorted (the row-sort kernel of ``csrc/row_sort.cu``, with the cluster
   kernel of ``csrc/cluster_sort.cu`` for rows past 2^15 keys), run-length
   counted and masked per query row (``csrc/open_count.cu``) by the open
   search's count core (``_open_count_core``): counts equal to the
   candidate-major stage 1's.

The per-spectrum entry capacity F is learned: the count core reports the
true largest entry count, and a batch past F is redone through the
two-dispatch path after F grows (the caller's contract).
"""

from __future__ import annotations

import os

import numpy as np
import torch

from .open_search import (
    _launch,
    _on_card,
    _open_count_core,
    _quarter_octave,
    _tol_args,
    spectrum_window_union,
)

# Elements of one [spectra, F] entry matrix per count-core call: the
# spectra of a batch are cut into chunks under it (each row's counts
# depend only on its own spectrum's entries, so the outputs do not
# change). Up to eight int64 matrices of this size are alive at once.
_CHUNK_ELEMS = 1 << 27


def _bounded_search(frag_mz, seg_lo, seg_hi, bound, nstep: int,
                    inclusive: bool):
    """First index in [seg_lo, seg_hi) whose mass is not < ``bound``
    (not <= with ``inclusive``): ``nstep`` steps of a binary search,
    vectorised over every (spectrum, band, peak) lane of ``bound``. NaN
    bounds compare false, which leaves an empty range."""
    lo = seg_lo.expand(bound.shape).clone()
    hi = seg_hi.expand(bound.shape).clone()
    n1 = frag_mz.shape[0] - 1
    for _ in range(nstep):
        mid = (lo + hi) // 2
        v = frag_mz[torch.clamp(mid, 0, n1).long()]
        pred = (v <= bound) if inclusive else (v < bound)
        pred = pred & (lo < hi)
        lo = torch.where(pred, mid + 1, lo)
        hi = torch.where(pred, hi, torch.minimum(mid, hi))
    return lo


def _banded_ranges_plain(frag_mz, masses, bb, *, Zb, tol, nstep):
    """Window ranges of every (spectrum, fragment charge, covered band,
    peak) by :func:`_bounded_search` in each covered band's segment
    ``bb`` i32 [B, nbcov, 2] of the (band, m/z)-sorted masses
    ``frag_mz``: i32 [B, Zb*nbcov*Pk] starts and lengths, column
    (zi*nbcov + k)*Pk + pk. The plain version of :func:`_banded_ranges`."""
    from .search import tol_bounds_static

    B, Pk = masses.shape
    nbcov = bb.shape[1]
    kind, lo_t, hi_t = tol
    seg_lo = bb[:, :, 0:1]  # [B, nbcov, 1]
    seg_hi = bb[:, :, 1:2]
    starts_z, lens_z = [], []
    for zi in range(Zb):
        lo_b, hi_b = tol_bounds_static(kind, lo_t, hi_t,
                                       masses * float(zi + 1))
        lo_b = lo_b[:, None, :].expand(B, nbcov, Pk)
        hi_b = hi_b[:, None, :].expand(B, nbcov, Pk)
        left = _bounded_search(frag_mz, seg_lo, seg_hi, lo_b, nstep, False)
        right = _bounded_search(frag_mz, seg_lo, seg_hi, hi_b, nstep, True)
        # +inf padding peaks give inf or NaN bounds; `v <= inf` holds for
        # every fragment, so unmasked they would claim whole band segments
        finite = torch.isfinite(lo_b) & torch.isfinite(hi_b)
        ln = torch.where(finite, torch.clamp(right - left, min=0),
                         torch.zeros_like(left))
        starts_z.append(left.reshape(B, nbcov * Pk))
        lens_z.append(ln.reshape(B, nbcov * Pk))
    return (torch.cat(starts_z, dim=1).to(torch.int32),
            torch.cat(lens_z, dim=1).to(torch.int32))


def _banded_ranges(frag_mz, masses, bb, *, Zb, tol, nstep):
    """:func:`_banded_ranges_plain`'s starts and lengths: on a CUDA
    tensor one launch of csrc/peak_ranges.cu's banded form (the same
    bounded search, each thread one (spectrum, z, band, peak) element, its
    bounds computed in place), on a CPU tensor the plain version."""
    if masses.device.type == "cpu":
        return _banded_ranges_plain(frag_mz, masses, bb, Zb=Zb, tol=tol,
                                    nstep=nstep)
    dev = _on_card("peak_ranges", masses, bb, frag_mz)
    masses = masses.float().contiguous()
    bb = bb.to(torch.int32).contiguous()
    mz = frag_mz.float().contiguous()
    B, Pk = masses.shape
    nbcov = int(bb.shape[1])
    if bb.shape != (B, nbcov, 2):
        raise ValueError(f"peak_ranges: segments {tuple(bb.shape)} for "
                         f"{B} spectra")
    st = torch.empty((B, Zb * nbcov * Pk), dtype=torch.int32, device=dev)
    ln = torch.empty_like(st)
    _launch("peak_ranges", "peak_ranges_banded", dev, masses.data_ptr(), B,
            Pk, bb.data_ptr(), nbcov, Zb, mz.data_ptr(), mz.numel(), nstep,
            *_tol_args(tol), st.data_ptr(), ln.data_ptr())
    return st, ln


def _banded_count(frag_mz, frag_pep, peaks_dev, bb, ints, row_spec, *, F, Pk,
                  Zb, K, R, nbcov, tol, nstep, n_pep):
    """Packed i32 [R, 2K+2] per-row top-K (vals, pep, matched total,
    scored) and the batch's largest per-spectrum entry count, i32 [1] (the
    overflow signal: the entries past F were dropped when it is >= F).

    frag_mz f32 [N] and frag_pep i32 [N]: the (band, m/z)-sorted fragment
    masses and peptide ids; peaks_dev f32 [2, B, Pk] (+inf pads); bb i32
    [B, nbcov, 2]: each covered band's segment [lo, hi); ints i32 [8, R]
    query rows (spectrum, p0, i0, i1, maxz, z, iso, slot); row_spec: the
    host's ascending spectrum ids of the live rows, ``ints[0]``'s first
    entries (the rows past them are padding sentinels)."""
    masses = peaks_dev[0]
    B = masses.shape[0]
    starts, lens = _banded_ranges(frag_mz, masses, bb, Zb=Zb, tol=tol,
                                  nstep=nstep)
    totmax = lens.sum(dim=1, dtype=torch.int32).max().reshape(1)

    def count(st, ln, r0, r1, s0):
        vals, cand, mtot, scored = _open_count_core(
            frag_pep, st, ln, ints[0, r0:r1] - s0, ints[2, r0:r1],
            ints[3, r0:r1], ints[4, r0:r1],
            F=F, Wc=8, Pk=nbcov * Pk, Z=Zb, K=K, R=r1 - r0, chunked=False,
            n_pep=n_pep,
        )
        return torch.cat([vals, cand, mtot[:, None], scored[:, None]], dim=1)

    bc = max(1, _CHUNK_ELEMS // max(F, 1))
    if B <= bc:
        return count(starts, lens, 0, R, 0), totmax
    # Chunks of spectra, their row bounds found on the host (a read of
    # ints would wait for the batch in flight). Rows are spectrum-grouped
    # in ascending order; the padding sentinel rows count nothing and
    # stay zero.
    packed = torch.zeros((R, 2 * K + 2), dtype=torch.int32,
                         device=ints.device)
    for s0 in range(0, B, bc):
        s1 = min(s0 + bc, B)
        r0, r1 = (int(x) for x in np.searchsorted(row_spec, [s0, s1]))
        if r1 > r0:
            packed[r0:r1] = count(starts[s0:s1], lens[s0:s1], r0, r1, s0)
    return packed, totmax


class NarrowBanded:
    """Per-Scorer state of the banded narrow stage 1: the (band,
    m/z)-sorted fragment arrays on the device and the learned
    per-spectrum entry capacity."""

    def __init__(self, db, K: int, *, device):
        n = int(db.fragment_pep_flat.shape[0])
        n_pep = len(db)
        self.n_pep = n_pep
        self.device = torch.device(device)
        bw = int(os.environ.get("SAGE_TPU_NARROW_BAND_W", "2048"))
        self.band_w = max(bw, 8)
        self.n_bands = max(-(-n_pep // self.band_w), 1)
        pep_flat = db.fragment_pep_flat.astype(np.int32)
        band = pep_flat // np.int32(self.band_w)
        order = np.argsort(band, kind="stable")  # keeps m/z order in-band
        counts = np.bincount(band, minlength=self.n_bands)
        self.band_off = np.concatenate([[0], np.cumsum(counts)]).astype(
            np.int64
        )
        # one +inf / -1 guard element keeps an empty index addressable
        mz = np.full(max(n, 1), np.inf, np.float32)
        mz[:n] = db.fragment_mz_flat[order]
        pep = np.full(max(n, 1), -1, np.int32)
        pep[:n] = pep_flat[order]
        self.frag_mz_dev = torch.from_numpy(mz).to(self.device)
        self.frag_pep_dev = torch.from_numpy(pep).to(self.device)
        self.K = K
        self.n_frags = n
        self._F = None
        self.nstep = int(np.ceil(np.log2(max(counts.max(initial=2), 2)))) + 2

    def estimate_F(self, frag_tol, Pk: int, Zb: int, nbcov: int) -> int:
        if self._F is not None:
            return self._F
        lo, hi = frag_tol.bounds(np.float32(1000.0))
        wfrac = max((float(hi) - float(lo)) / 1000.0, 1e-7)
        per_band = self.n_frags / self.n_bands
        est = per_band * wfrac * Pk * Zb * nbcov * 2.0 + 64.0
        F = _quarter_octave(int(est) + 1)
        F = ((max(F, self.K, 128) + 127) // 128) * 128
        self._F = F
        return F

    def grow_F(self, needed: int) -> None:
        F = _quarter_octave(int(needed * 1.5) + 1)
        self._F = ((max(F, self._F or 128, 128) + 127) // 128) * 128

    def covered(self, rows, B: int):
        """The [B, nbcov, 2] covered-band segment bounds of each
        spectrum's precursor-window union, and nbcov (a power of two)."""
        u0, u1 = spectrum_window_union(rows, B)
        b0 = np.clip(u0 // self.band_w, 0, self.n_bands - 1)
        b1 = np.clip(np.maximum(u1 - 1, 0) // self.band_w, 0,
                     self.n_bands - 1)
        b1 = np.maximum(b1, b0)
        ncov = int((b1 - b0 + 1).max()) if B else 1
        nbcov = 1
        while nbcov < ncov:
            nbcov *= 2
        bands = b0[:, None] + np.arange(nbcov)[None, :]  # [B, nbcov]
        valid = bands <= b1[:, None]
        bands = np.clip(bands, 0, self.n_bands - 1)
        bb = np.zeros((B, nbcov, 2), np.int32)
        bb[:, :, 0] = self.band_off[bands]
        bb[:, :, 1] = np.where(valid, self.band_off[bands + 1],
                               self.band_off[bands])
        return bb, nbcov

    def dispatch(self, peaks_dev, rows, ints_dev, R: int, Zb: int, frag_tol,
                 Pk: int):
        """Launch the banded count for the fused path's [8, R] query rows
        ``ints_dev`` (original row order, one segment). Returns (packed
        [R, 2K+2], totmax [1], F, nbcov); the caller reads totmax through
        its own fetch and redoes the batch when it reached F."""
        B = int(peaks_dev.shape[1])
        bb, nbcov = self.covered(rows, B)
        F = self.estimate_F(frag_tol, Pk, Zb, nbcov)
        tol = (frag_tol.kind, float(frag_tol.lo), float(frag_tol.hi))
        packed, totmax = _banded_count(
            self.frag_mz_dev, self.frag_pep_dev, peaks_dev,
            torch.from_numpy(bb).to(self.device), ints_dev, rows["si"],
            F=F, Pk=Pk, Zb=Zb, K=self.K, R=R, nbcov=nbcov, tol=tol,
            nstep=self.nstep, n_pep=self.n_pep,
        )
        return packed, totmax, F, nbcov
