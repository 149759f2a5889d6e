"""Peak-major preliminary counts for the open search (wide precursor
windows), in PyTorch.

Counterpart of ``sage_tpu/ops/open_search.py``. The candidate-major
stage 1 regenerates every candidate's ion ladder, which suits narrow
windows; a -500/+100 Da window spans much of the peptide table, so the
open search walks the flat fragment index instead (the reference's
bucketed index walk, database.rs:480-536 and scoring.rs:335-382):

1. The flat fragment index is segmented into peptide-mass BANDS, sorted
   by (band, m/z). For every (peak, fragment charge, covered band) the
   tolerance window is a contiguous range of that band's sorted
   segment: on the host by ``np.searchsorted`` (:meth:`OpenSearcher.ranges`)
   or on the device with the same ranks (:meth:`OpenSearcher.ranges_device`,
   ``ranges_device_slots``): on the card one launch of
   ``csrc/peak_ranges.cu`` (a binary search a window end), on the CPU
   the plain version, a three-level decimated rank probe (:func:`_probe`).
   Only bands that meet the spectrum's precursor-window union are
   searched.
2. Each range's peptide ids are gathered into one entry row per
   (spectrum, band) (:func:`open_entries`; ``csrc/open_entries.cu`` on
   the card), as packed int32 keys ``((2^25 - pep) << 5) | z``
   (``2^25 - pep`` when there is one fragment-charge plane), and each row
   is sorted by the kernels of ``pallas_sort`` (peptide descending;
   invalid entries are INT32_MAX and sort to the tail); rows past
   ``MAX_F`` keys take ``torch.sort`` of -pep keys, as the JAX package
   takes ``lax.sort`` there.
3. Per query row (spectrum x charge x isotope) the entries are masked by
   the row's precursor range [i0, i1) and fragment-charge bound, counted
   by run length, and the top-K (count desc, peptide desc) kept exactly:
   the PreScore tie rule (scoring.rs:43-49) (:func:`open_count`;
   ``csrc/open_count.cu`` on the card, a warp a query row (a block past
   K = 64) walking only its window's entries, the end of each row's live
   prefix taken from the gather's live count).

Every wrapper launches its kernel on a CUDA tensor and takes the plain
version (torch ops, kept beside it) on a CPU tensor;
``launches`` counts the kernels' launches, as do the recorder's
``launch.<kernel>`` counters (``utils/trace.py``).

Returns the packed [R, 2K+2] i32 layout of the fused path's merge
(vals[K], pep[K], matched_total, scored); the two-dispatch path takes the
same layout from :meth:`OpenSearcher.preliminary_packed`, which splits a
batch past the element budget recursively. Every integer field that the
JAX package packs as int32 stays int32.
"""

from __future__ import annotations

import ctypes
import os
from typing import Dict, Tuple

import numpy as np
import torch

from .pallas_sort import INT32_MAX, bitonic_sort_rows, use_pallas_sort
from .pallas_stage1 import _TOL_KIND
from ..utils import trace

F32 = np.float32

# Entries per row of the [N / V_ROW, V_ROW] fragment-peptide table that
# the row-aligned gather fetches whole (_entries_rows). It sets the
# static shapes (Wc, F) that the sticky batch planning records, so it
# keeps the JAX package's value.
V_ROW = 64

# elements of a [rows, axis] intermediate per chunk
_CHUNK = 1 << 24
# packed-key constants: peptide ids below 2^25, INT32_MAX for no entry
_PMAX = 1 << 25
_NOPEP = 1 << 30

# Launches of the CUDA kernels, counted by their wrappers: the window-range
# search (csrc/peak_ranges.cu; its banded form is launched from
# ops/narrow_banded.py), the entry gather (csrc/open_entries.cu) and the
# run-count top-K (csrc/open_count.cu).
launches = {"peak_ranges": 0, "open_entries": 0, "open_count": 0}


def _bind(name: str):
    from ._cuda_build import load

    lib = load(name)
    i, ll, f, p = (ctypes.c_int, ctypes.c_longlong, ctypes.c_float,
                   ctypes.c_void_p)
    sigs = {
        "peak_ranges": {
            "peak_ranges_open": [p, i, i, p, p, p, ll, i, i, i] + [p] * 6
                                + [i, f, f, p, p, p],
            "peak_ranges_banded": [p, i, i, p, i, i, p, ll, i, i, f, f, p,
                                   p, p],
        },
        "open_entries": {"open_entries": [p, ll, p, p] + [i] * 8
                         + [p] * 4},
        "open_count": {"open_count": [p, ll, p, ll, p] + [i] * 4
                       + [p] * 4 + [i] * 3 + [p, p],
                       "open_count_max_k": []},
    }[name]
    for fn, args in sigs.items():
        c = getattr(lib, fn)
        if c.argtypes is None:
            c.argtypes = args
            c.restype = ctypes.c_int
    return lib


def _launch(name: str, fn: str, device, *args):
    """Call the C entry point ``fn`` of ``csrc/<name>.cu`` on ``device``'s
    current stream; raise if the launch failed, else count it."""
    lib = _bind(name)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = getattr(lib, fn)(*args, stream)
    if rc != 0:
        raise RuntimeError(f"{fn} launch failed: CUDA error {rc}")
    launches[name] += 1
    trace.count("launch." + name)


def _on_card(name: str, *ts):
    """Raise unless every tensor of ``ts`` lies on one CUDA device."""
    dev = ts[0].device
    if dev.type != "cuda":
        raise ValueError(f"{name}: unsupported device {dev}")
    if any(t.device != dev for t in ts):
        raise ValueError(f"{name}: tensors must share one device")
    return dev


def _tol_args(tol):
    kind, lo, hi = tol
    if kind not in _TOL_KIND:
        raise ValueError(f"tolerance kind {kind!r}")
    return (_TOL_KIND[kind], float(np.float32(lo)), float(np.float32(hi)))


def _quarter_octave(n: int) -> int:
    """Smallest value >= n of the form (4..7) * 2^k — static-shape
    padding with <= 4 buckets per octave and <= 12.5% mean waste."""
    octave = 8
    while octave * 2 <= n:
        octave *= 2
    return octave * (-(-n * 4 // octave)) // 4


def spectrum_window_union(rows, B):
    """Per-spectrum union [u0, u1) of the precursor-window peptide-index
    ranges of its query rows (0-width where a spectrum has no live
    rows)."""
    u0 = np.full(B, np.iinfo(np.int64).max, np.int64)
    u1 = np.zeros(B, np.int64)
    live = rows["i1"] > rows["i0"]
    if live.any():
        np.minimum.at(u0, rows["si"][live], rows["i0"][live])
        np.maximum.at(u1, rows["si"][live], rows["i1"][live])
    return np.where(u1 > 0, u0, 0), u1


def covered_bands(u0, u1, band_w: int, nb: int, B: int):
    """Per-spectrum covered band range (b0, b1) and the slot count nbcov
    (the widest spectrum's), shared by the host and device range probes
    and the element-budget check."""
    if u0 is None or nb == 1:
        b0 = np.zeros(B, np.int64)
        b1 = np.full(B, nb - 1, np.int64)
    else:
        b0 = np.clip(u0 // band_w, 0, nb - 1).astype(np.int64)
        b1 = np.clip(
            np.maximum(u1 - 1, 0) // band_w, 0, nb - 1
        ).astype(np.int64)
        b1 = np.maximum(b1, b0)
    nbcov = int((b1 - b0 + 1).max()) if B else 1
    return b0, b1, nbcov


def _probe(tabs, lo_b, hi_b, bids, valid):
    """Exact window ranges of the bounds ``lo_b``/``hi_b`` f32 [N, Pk]
    (NaN or inf where a peak is padding) in band ``bids`` [N] of the
    band-segmented sorted masses: starts and lengths, i32 [N, Pk], equal
    to the host's ``np.searchsorted`` ranges. Rows with ``valid`` False,
    non-finite bounds and windows that miss the band's mass span come out
    (0, 0), as on the host.

    The rank of a bound among its band's sorted masses is found in three
    levels, each exact because the masses, and so every decimation of
    them, are non-decreasing within a band (+inf padded):
    1. the 4096x decimation ``dec2`` locates the 64-group of ``dec`` (the
       64x decimation) that holds the boundary — a search of a sorted
       row, which counts exactly the elements the JAX package's dense
       compare counts;
    2. a compare-count inside that 64-group gives the rank among the
       64x-decimated values, which locates the one 64-lane mass row that
       can hold the boundary;
    3. a masked compare-count inside that row finishes it."""
    mz64, decg, dec2, row_off, blen, boff, bfirst, blast = tabs
    N, Pk = lo_b.shape
    NR = mz64.shape[0]
    DEC2 = dec2.shape[1]
    lane = torch.arange(64, device=lo_b.device)
    finite = torch.isfinite(lo_b) & torch.isfinite(hi_b)
    big = torch.full_like(lo_b, 3.0e38)
    bounds = (torch.where(finite, lo_b, big), torch.where(finite, hi_b, big))
    st = torch.empty((N, Pk), dtype=torch.int32, device=lo_b.device)
    ln = torch.empty_like(st)
    step = max(1, _CHUNK // max(Pk * 64, 1))
    for a in range(0, N, step):
        b = min(a + step, N)
        bid = bids[a:b]
        ro = row_off[bid][:, None]
        bl = blen[bid][:, None]
        rows_b = (bl + 63) // 64
        ranks = []
        for strict, bound in zip((True, False), bounds):
            bd = bound[a:b]
            # level 1: # of dec2 values < bound (strict) or <= bound
            q = torch.searchsorted(dec2[bid].contiguous(), bd.contiguous(),
                                   right=not strict)
            qc = torch.clamp(q, max=DEC2 - 1)
            # level 2: rank among the 64x-decimated values
            dg = decg[bid[:, None], qc]                      # [n, Pk, 64]
            c2 = (dg < bd[..., None]) if strict else (dg <= bd[..., None])
            j2 = qc * 64 + c2.sum(dim=-1)
            jr = torch.minimum(j2, torch.clamp(rows_b - 1, min=0))
            # level 3: rank inside the one mass row
            vals = mz64[torch.clamp(ro + jr, 0, NR - 1)]      # [n, Pk, 64]
            ok = (jr[..., None] * 64 + lane) < bl[..., None]
            c3 = (vals < bd[..., None]) if strict else (vals <= bd[..., None])
            cnt = (c3 & ok).sum(dim=-1)
            ranks.append(torch.minimum(jr * 64 + cnt, bl))
        # the host's shortcut: a window that misses the band's mass span
        # keeps (0, 0)
        hit = (
            finite[a:b] & valid[a:b, None]
            & (hi_b[a:b] >= bfirst[bid][:, None])
            & (lo_b[a:b] <= blast[bid][:, None])
        )
        zero = torch.zeros_like(ranks[0])
        ln[a:b] = torch.where(hit, torch.clamp(ranks[1] - ranks[0], min=0),
                              zero)
        st[a:b] = torch.where(hit, boff[bid][:, None] + ranks[0], zero)
    return st, ln


def _peak_bounds(masses, zi: int, tol):
    from .search import tol_bounds_static

    kind, lo_t, hi_t = tol
    return tol_bounds_static(kind, lo_t, hi_t, masses * float(zi + 1))


def _device_ranges_plain(tabs, peaks, band_ids, bvalid, *, Zb, tol):
    """Exact per-(z, covered band, peak) window ranges for the [B, nbcov]
    grid of (spectrum, covered band) slots: i32 [B, Zb*nbcov*Pk] starts
    and lengths, column (zi*nbcov + k)*Pk + pk — equal to
    :meth:`OpenSearcher.ranges`. The plain version of
    :func:`_device_ranges`, through :func:`_probe`."""
    masses = peaks[0]
    B, Pk = masses.shape
    nbcov = band_ids.shape[1]
    bids = band_ids.reshape(-1)
    valid = bvalid.reshape(-1)
    st_l, ln_l = [], []
    for zi in range(Zb):
        lo_b, hi_b = _peak_bounds(masses, zi, tol)
        rep = (lambda t: t[:, None, :].expand(B, nbcov, Pk)
               .reshape(B * nbcov, Pk))
        st, ln = _probe(tabs, rep(lo_b), rep(hi_b), bids, valid)
        st_l.append(st.view(B, nbcov * Pk))
        ln_l.append(ln.view(B, nbcov * Pk))
    return torch.cat(st_l, dim=1), torch.cat(ln_l, dim=1)


def _device_ranges_flat_plain(tabs, peaks, slot_spec, slot_band,
                              slot_valid, *, Zb, tol):
    """Slot-major form of :func:`_device_ranges_plain` for an explicit
    list of (spectrum, band) slots: i32 [NS, Zb*Pk], column zi*Pk + pk;
    invalid (padding) slots come out all zero."""
    masses = peaks[0]
    st_l, ln_l = [], []
    for zi in range(Zb):
        lo_b, hi_b = _peak_bounds(masses, zi, tol)
        st, ln = _probe(tabs, lo_b[slot_spec], hi_b[slot_spec], slot_band,
                        slot_valid)
        st_l.append(st)
        ln_l.append(ln)
    return torch.cat(st_l, dim=1), torch.cat(ln_l, dim=1)


def _peak_ranges(tabs, masses, band, valid, *, nsub, Zb, tol, spec=None):
    """The window ranges of csrc/peak_ranges.cu's open form: i32
    [NS / nsub, Zb*nsub*Pk] starts and lengths of every (slot, z, peak),
    slot s reading spectrum ``spec[s]`` (or s // nsub) of ``masses``
    [B, Pk] in band ``band[s]``, column (zi*nsub + s % nsub)*Pk + pk."""
    mz64, _decg, _dec2, row_off, blen, boff, bfirst, blast = tabs
    dev = _on_card("peak_ranges", masses, band, valid, mz64)
    B, Pk = masses.shape
    NS = int(band.shape[0])
    ts = [masses.float().contiguous(), band.long().contiguous(),
          valid.bool().contiguous()]
    if spec is not None:
        spec = spec.to(dev).long().contiguous()
    st = torch.empty((NS // nsub, Zb * nsub * Pk), dtype=torch.int32,
                     device=dev)
    ln = torch.empty_like(st)
    _launch("peak_ranges", "peak_ranges_open", dev,
            ts[0].data_ptr(), B, Pk,
            None if spec is None else spec.data_ptr(), ts[1].data_ptr(),
            ts[2].data_ptr(), NS, nsub, Zb, int(blen.shape[0]),
            mz64.data_ptr(), row_off.data_ptr(), blen.data_ptr(),
            boff.data_ptr(), bfirst.data_ptr(), blast.data_ptr(),
            *_tol_args(tol), st.data_ptr(), ln.data_ptr())
    return st, ln


def _device_ranges(tabs, peaks, band_ids, bvalid, *, Zb, tol):
    """Exact per-(z, covered band, peak) window ranges for the [B, nbcov]
    grid of (spectrum, covered band) slots, laid out as
    :func:`_device_ranges_plain`'s: on a CUDA tensor one launch of
    csrc/peak_ranges.cu, on a CPU tensor the plain version."""
    if peaks.device.type == "cpu":
        return _device_ranges_plain(tabs, peaks, band_ids, bvalid, Zb=Zb,
                                    tol=tol)
    nbcov = int(band_ids.shape[1])
    return _peak_ranges(tabs, peaks[0], band_ids.reshape(-1),
                        bvalid.reshape(-1), nsub=nbcov, Zb=Zb, tol=tol)


def _device_ranges_flat(tabs, peaks, slot_spec, slot_band, slot_valid, *,
                        Zb, tol):
    """Slot-major form of :func:`_device_ranges` for an explicit list of
    (spectrum, band) slots: i32 [NS, Zb*Pk], column zi*Pk + pk; invalid
    (padding) slots come out all zero. A CUDA tensor launches
    csrc/peak_ranges.cu, a CPU tensor takes the plain version."""
    if peaks.device.type == "cpu":
        return _device_ranges_flat_plain(tabs, peaks, slot_spec, slot_band,
                                         slot_valid, Zb=Zb, tol=tol)
    return _peak_ranges(tabs, peaks[0], slot_band, slot_valid, nsub=1,
                        Zb=Zb, tol=tol, spec=slot_spec)


def _range_stats(starts, lens, *, nbcov=1, Zb=1, Pk=1):
    """Device i32 [2]: the max per-(spectrum, band) entry total and the
    max per-(spectrum, band) gather-row total — the sticky-shape overflow
    check of device-planned open batches. With nbcov == 1 the unit is
    the whole row."""
    B = starts.shape[0]
    st = starts.long()
    ln = lens.long()
    rows = torch.where(
        ln > 0, (st + ln + (V_ROW - 1)) // V_ROW - st // V_ROW, 0
    )
    if nbcov > 1:
        ln = ln.view(B, Zb, nbcov, Pk).sum(dim=(1, 3))
        rows = rows.view(B, Zb, nbcov, Pk).sum(dim=(1, 3))
    else:
        ln = ln.sum(dim=1)
        rows = rows.sum(dim=1)
    return torch.stack([ln.max(), rows.max()]).to(torch.int32)


def _entries_rows(frag_pep8, starts, lens, Wr, Pk, Z):
    """Row-aligned gather: [B, Wr*V_ROW] i32 entry keys (-pep, or 2^30
    where there is no entry) and, for Z > 1, i32 fragment-charge tags.
    Window w (fragment range [s, e)) owns the whole V_ROW-aligned table
    rows floor(s/V) .. ceil(e/V); per-element masks trim the slack."""
    B, Wn = starts.shape
    dev = starts.device
    N8 = frag_pep8.shape[0]
    st = starts.long()
    ends = st + lens.long()
    r0 = st // V_ROW
    nr = torch.where(lens > 0, (ends + (V_ROW - 1)) // V_ROW - r0, 0)
    cumr = torch.cumsum(nr, dim=1)
    cumr0 = cumr - nr
    tr = cumr[:, -1]
    # owning window of each row slot: every window marks its first slot,
    # cumsum - 1 is the last window starting at or before the slot (empty
    # windows share the next window's start and are never the last mark
    # of an occupied slot); trailing empty windows mark column Wr, which
    # is dropped. Duplicate positions add up.
    marks = torch.zeros((B, Wr + 1), dtype=torch.int64, device=dev)
    marks.scatter_add_(1, torch.clamp(cumr0, max=Wr),
                       torch.ones_like(cumr0))
    w_of = torch.clamp(torch.cumsum(marks[:, :Wr], dim=1) - 1, 0, Wn - 1)
    slot = torch.arange(Wr, device=dev)[None, :]
    row = torch.gather(r0, 1, w_of) + (slot - torch.gather(cumr0, 1, w_of))
    row_ok = slot < tr[:, None]
    row = torch.clamp(row, 0, N8 - 1)
    g = frag_pep8[row]                                    # [B, Wr, V] i32
    gpos = row[..., None] * V_ROW + torch.arange(V_ROW, device=dev)
    ws = torch.gather(st, 1, w_of)[..., None]
    we = torch.gather(ends, 1, w_of)[..., None]
    evalid = row_ok[..., None] & (gpos >= ws) & (gpos < we) & (g >= 0)
    neg = torch.where(evalid, -g, _NOPEP).reshape(B, Wr * V_ROW)
    if Z == 1:
        return neg, None
    # fragment-charge tag of each entry's window (z-major: w = (z-1)*Pk+pk)
    z_of = (w_of // Pk + 1).to(torch.int32)[..., None].expand(B, Wr, V_ROW)
    return neg, z_of.reshape(B, Wr * V_ROW)


def _entries_flat(frag_pep8, starts, lens, F, Pk, Z):
    """Ragged flatten: [B, F] i32 entry keys (-pep, or 2^30) and, for
    Z > 1, fragment-charge tags. Entry j of row b reads fragment
    starts[b, w] + (j - cum[b, w-1]) of its window w, built by
    scatter-adding the per-window offset deltas and a cumsum."""
    B, Wn = starts.shape
    dev = starts.device
    frag_pep = frag_pep8.reshape(-1)
    ln = lens.long()
    cum = torch.cumsum(ln, dim=1)
    cum0 = cum - ln
    total = cum[:, -1]
    off_w = starts.long() - cum0
    off_delta = torch.cat([off_w[:, :1], off_w[:, 1:] - off_w[:, :-1]], dim=1)
    clip_pos = torch.clamp(cum0, max=F - 1)
    # windows with len 0 still carry their delta so later offsets stay
    # right; duplicate positions add up
    deltas = torch.zeros((B, F), dtype=torch.int64, device=dev)
    deltas.scatter_add_(1, clip_pos, off_delta)
    jpos = torch.arange(F, device=dev)[None, :]
    src = torch.clamp(torch.cumsum(deltas, dim=1) + jpos, 0,
                      frag_pep.shape[0] - 1)
    pep = torch.where(jpos < total[:, None], frag_pep[src], -1)
    neg = torch.where(pep >= 0, -pep, _NOPEP)
    if Z == 1:
        return neg, None
    marks = torch.zeros((B, F), dtype=torch.int64, device=dev)
    marks.scatter_add_(1, clip_pos, torch.ones_like(clip_pos))
    w_of = torch.cumsum(marks, dim=1) - 1
    z_of = torch.clamp(w_of, 0, Z * Pk - 1) // Pk + 1
    return neg, z_of.to(torch.int32)


def _topk_counts(cnt, K):
    """Exact top-K of i32 counts [r, Fax] in (count desc, index asc)
    order, for every K: ``torch.topk`` on the int64 key
    (count << 32) | (Fax - 1 - pos), distinct for every entry, so no two
    keys tie and the order is fixed."""
    Fax = cnt.shape[1]
    pos_rev = torch.arange(Fax - 1, -1, -1, dtype=torch.int64,
                           device=cnt.device)
    top = torch.topk((cnt.long() << 32) | pos_rev, K, dim=1).values
    return (top >> 32).to(torch.int32), (Fax - 1) - (top & 0xFFFFFFFF)


def _live_count(keys, packed):
    """i32 [rows]: the keys of each row that hold an entry."""
    empty = INT32_MAX if packed else _NOPEP
    return (keys != empty).sum(dim=1, dtype=torch.int32)


def open_entries_plain(frag_pep8, starts, lens, *, F, Wc, Pk, Z, nbcov,
                       chunked, packed):
    """The entry rows that the sort reads, one pseudo-row a (spectrum,
    covered band) pair, from the windows' ranges ``starts`` / ``lens`` i32
    [B, Z*nbcov*Pk] (column (z*nbcov + k)*Pk + pk): [B*nbcov, W] i32, W =
    Wc*V_ROW (the row-aligned gather, ``chunked``) or F (the ragged
    flatten). ``packed``: the sort kernels' key ((2^25 - pep) << 5) | z
    (2^25 - pep with Z == 1), INT32_MAX where there is no entry, and no
    tags; else -pep (2^30 where there is no entry) and, for Z > 1, i32
    fragment-charge tags. Returns (keys, tags or None, live), live i32
    [B*nbcov] each row's count of keys that hold an entry: the length of
    the live prefix the sort leaves, which the count takes."""
    B = starts.shape[0]
    if nbcov > 1:
        BN = B * nbcov
        st = starts.view(B, Z, nbcov, Pk).permute(0, 2, 1, 3).reshape(
            BN, Z * Pk)
        ln = lens.view(B, Z, nbcov, Pk).permute(0, 2, 1, 3).reshape(
            BN, Z * Pk)
    else:
        st, ln = starts, lens
    if chunked:
        neg, z_of = _entries_rows(frag_pep8, st, ln, Wc, Pk, Z)
    else:
        neg, z_of = _entries_flat(frag_pep8, st, ln, F, Pk, Z)
    if not packed:
        return neg, z_of, _live_count(neg, False)
    # the row-sort kernels: one i32 key per entry, the z tag packed into
    # the low 5 bits
    pep_e = torch.where(neg < _NOPEP, -neg, -1)
    valid_e = pep_e >= 0
    key = ((_PMAX - pep_e) if z_of is None
           else (((_PMAX - pep_e) << 5) | z_of))
    keys = torch.where(valid_e, key, INT32_MAX).to(torch.int32)
    return keys, None, _live_count(keys, True)


def open_entries(frag_pep8, starts, lens, *, F, Wc, Pk, Z, nbcov, chunked,
                 packed):
    """:func:`open_entries_plain`'s rows, tags and live counts: on a CUDA
    tensor one launch of csrc/open_entries.cu (a block a row, copying
    unit by unit through an owner map), on a CPU tensor the plain
    version. The window
    lengths are >= 0, as every range search gives them."""
    if starts.device.type == "cpu":
        return open_entries_plain(frag_pep8, starts, lens, F=F, Wc=Wc, Pk=Pk,
                                  Z=Z, nbcov=nbcov, chunked=chunked,
                                  packed=packed)
    dev = _on_card("open_entries", starts, lens, frag_pep8)
    pep = frag_pep8.reshape(-1)
    st = starts.to(torch.int32).contiguous()
    ln = lens.to(torch.int32).contiguous()
    checks = (
        (pep.dtype == torch.int32 and pep.is_contiguous(),
         "the fragment-peptide table must be a contiguous i32 tensor"),
        (st.dim() == 2 and st.shape == ln.shape
         and st.shape[1] == Z * nbcov * Pk,
         f"ranges {tuple(st.shape)} for Z={Z}, nbcov={nbcov}, Pk={Pk}"),
        (0 < pep.numel() < 2**31, "the fragment-peptide table must hold "
         "1 to 2^31 - 1 entries"),
        (not chunked or (pep.numel() % V_ROW == 0
                         and pep.data_ptr() % 16 == 0),
         "the row-aligned gather needs whole, 16-byte aligned 64-entry "
         "table rows"),
    )
    for ok, msg in checks:
        if not ok:
            raise ValueError(f"open_entries: {msg}")
    B = st.shape[0]
    BN = B * nbcov
    W = Wc * V_ROW if chunked else F
    keys = torch.empty((BN, W), dtype=torch.int32, device=dev)
    tags = (torch.empty_like(keys) if not packed and Z > 1 else None)
    # the kernel writes every row's count; rows of no columns launch none
    live = (torch.empty if BN * W else torch.zeros)(BN, dtype=torch.int32,
                                                    device=dev)
    if BN * W:
        _launch("open_entries", "open_entries", dev, pep.data_ptr(),
                pep.numel(), st.data_ptr(), ln.data_ptr(), B, nbcov, Z, Pk,
                int(chunked), Wc, F, int(packed), keys.data_ptr(),
                None if tags is None else tags.data_ptr(), live.data_ptr())
    return keys, tags, live


def open_count_plain(rows, z_sorted, live, row_spec, row_i0, row_i1,
                     row_maxz, *, F, K, nbcov, Z, packed):
    """Per query row: mask the sorted entry rows by the row's precursor
    range [i0, i1) and fragment-charge bound, count each peptide's run,
    keep the exact top-K in (count desc, peptide desc) order. ``rows``
    [BN, >= F] i32, sorted ascending, as :func:`open_entries` writes them
    (``packed``, or -pep keys with ``z_sorted`` [BN, F] tags for Z > 1),
    cut to their first F columns here; ``live`` [BN], each row's count of
    keys that hold an entry (:func:`open_entries`'s), is what the kernel
    takes for the end of a row's live prefix: the plain version reads
    the entries from the keys themselves and raises if ``live`` differs
    from their count, so every caller's count is checked wherever the
    plain version runs. ``row_spec`` [R] names each query
    row's spectrum, whose pseudo-rows are spec*nbcov + slot. Returns the
    fused merge's i32 [R, 2K+2] layout (vals, cand, matched_total,
    scored).

    With nbcov > 1 each (spectrum, covered band) pair is its own
    pseudo-row. That is exact because bands partition peptide ids:
    per-band run-length counts are the global counts, every global top-K
    candidate survives its band's top-K, and matched/scored totals sum
    across bands. The global top-K is a (count desc, peptide desc) sort
    over the nbcov*K per-band winners."""
    BN = rows.shape[0]
    R = row_spec.shape[0]
    dev = rows.device
    if not torch.equal(live.to(torch.int32), _live_count(rows, packed)):
        raise ValueError("open_count: live counts differ from the rows' "
                         "entries")
    x = rows[:, :F]
    if packed:
        valid_s = x != INT32_MAX
        if Z == 1:
            pep_sorted = torch.where(valid_s, _PMAX - x, -1)
            z_sorted = None
        else:
            pep_sorted = torch.where(valid_s, _PMAX - (x >> 5), -1)
            z_sorted = torch.where(valid_s, x & 31, 0)
    else:
        pep_sorted = torch.where(x < _NOPEP, -x, -1)
        if z_sorted is not None:
            z_sorted = z_sorted[:, :F]

    Fax = int(pep_sorted.shape[1])
    change = pep_sorted[:, 1:] != pep_sorted[:, :-1]
    edge = torch.ones((BN, 1), dtype=torch.bool, device=dev)
    run_start = torch.cat([edge, change], dim=1)
    run_end = torch.cat([change, edge], dim=1)
    pos = torch.arange(Fax, dtype=torch.int32, device=dev)[None, :]
    if z_sorted is None:
        # one fragment-charge plane: a run's count is its full length
        # whatever the query row, so run lengths are computed once per
        # pseudo-row and each query row only masks whole runs by [i0, i1)
        base_pos = torch.cummax(torch.where(run_start, pos, 0), dim=1).values
        rl_end = torch.where(run_end & (pep_sorted >= 0),
                             pos - base_pos + 1, 0)

    # per query row: mask by precursor range and charge bound, count.
    # Padding rows (row_spec = a sentinel >= B) read the last pseudo-row;
    # their empty [i0, i1) masks every count to 0.
    if nbcov > 1:
        slots = torch.arange(nbcov, dtype=torch.int64, device=dev)
        spec_all = (row_spec.long()[:, None] * nbcov + slots).reshape(-1)
        i0_all = row_i0.repeat_interleave(nbcov)
        i1_all = row_i1.repeat_interleave(nbcov)
        mz_all = row_maxz.repeat_interleave(nbcov)
    else:
        spec_all, i0_all, i1_all, mz_all = (row_spec.long(), row_i0, row_i1,
                                            row_maxz)
    spec_all = torch.clamp(spec_all, 0, BN - 1)
    n_all = spec_all.shape[0]
    vals = torch.empty((n_all, K), dtype=torch.int32, device=dev)
    cand = torch.empty_like(vals)
    mtot = torch.empty(n_all, dtype=torch.int32, device=dev)
    scored = torch.empty_like(mtot)
    step = max(1, _CHUNK // max(Fax, 1))
    for a in range(0, n_all, step):
        b = min(a + step, n_all)
        spec = spec_all[a:b]
        p = pep_sorted[spec]
        in_win = (p >= i0_all[a:b, None]) & (p < i1_all[a:b, None])
        if z_sorted is None:
            cnt = torch.where(in_win, rl_end[spec], 0)
            mtot[a:b] = cnt.sum(dim=1, dtype=torch.int32)
        else:
            ok = in_win & (z_sorted[spec] < mz_all[a:b, None])
            cs = torch.cumsum(ok, dim=1, dtype=torch.int32)
            # masked count at each run's start carried to its end: cs - ok
            # is non-decreasing, so a cummax over (run start ? it : 0)
            # carries the latest run start forward
            base = torch.cummax(
                torch.where(run_start[spec], cs - ok.to(torch.int32), 0),
                dim=1).values
            cnt = torch.where(run_end[spec] & (p >= 0), cs - base, 0)
            mtot[a:b] = (ok & (p >= 0)).sum(dim=1, dtype=torch.int32)
        scored[a:b] = (cnt > 0).sum(dim=1, dtype=torch.int32)
        v, idx = _topk_counts(cnt, K)
        vals[a:b] = v
        cand[a:b] = torch.where(v > 0, torch.gather(p, 1, idx), 0)
    if nbcov > 1:
        # exact global top-K: (count desc, peptide desc) over the union of
        # the per-band top-Ks, as one int64 key (cand >= 0)
        key = ((vals.long() << 32) | cand.long()).view(R, nbcov * K)
        key = torch.sort(key, dim=1, descending=True).values[:, :K]
        vals = (key >> 32).to(torch.int32)
        cand = torch.where(vals > 0, (key & 0xFFFFFFFF).to(torch.int32), 0)
        mtot = mtot.view(R, nbcov).sum(dim=1, dtype=torch.int32)
        scored = scored.view(R, nbcov).sum(dim=1, dtype=torch.int32)
    return torch.cat([vals, cand, mtot[:, None], scored[:, None]], dim=1)


def open_count(rows, z_sorted, live, row_spec, row_i0, row_i1, row_maxz, *,
               F, K, nbcov, Z, packed):
    """:func:`open_count_plain`'s [R, 2K+2] output: on a CUDA tensor one
    launch of csrc/open_count.cu (a warp a query row for K <= 64, else a
    block, each walking only its window's entries), on a CPU tensor the
    plain version. Every ``rows`` row must be sorted ascending, as the
    sorts leave it, and ``live`` must count its keys that hold an entry,
    as :func:`open_entries` returns it."""
    if rows.device.type == "cpu":
        return open_count_plain(rows, z_sorted, live, row_spec, row_i0,
                                row_i1, row_maxz, F=F, K=K, nbcov=nbcov,
                                Z=Z, packed=packed)
    qs = [t.to(torch.int32).contiguous()
          for t in (row_spec, row_i0, row_i1, row_maxz)]
    live = live.to(torch.int32).contiguous()
    dev = _on_card("open_count", rows, live, *qs,
                   *(() if z_sorted is None else (z_sorted,)))
    BN = rows.shape[0]
    R = qs[0].shape[0]
    has_z = Z > 1
    checks = (
        (rows.dtype == torch.int32 and rows.dim() == 2
         and rows.stride(1) == 1, "rows must be i32 [BN, W] with unit "
         "column stride"),
        (packed or not has_z or (
            z_sorted is not None and z_sorted.dtype == torch.int32
            and z_sorted.stride(1) == 1 and z_sorted.shape[0] == BN),
         "-pep keys with Z > 1 need i32 charge tags beside them"),
        (all(q.shape == (R,) for q in qs), "query rows must be [R] each"),
        (live.shape == (BN,), f"live counts {tuple(live.shape)} for "
         f"{BN} rows"),
        (1 <= K <= _bind("open_count").open_count_max_k(),
         f"K={K} is past the kernel's top-K buffer"),
    )
    for ok, msg in checks:
        if not ok:
            raise ValueError(f"open_count: {msg}")
    out = torch.empty((R, 2 * K + 2), dtype=torch.int32, device=dev)
    Fax = min(int(F), int(rows.shape[1]))
    if R:
        zs = z_sorted if (has_z and not packed) else None
        _launch("open_count", "open_count", dev, rows.data_ptr(),
                rows.stride(0), None if zs is None else zs.data_ptr(),
                0 if zs is None else zs.stride(0), live.data_ptr(), BN, Fax,
                (1 if has_z else 0) if packed else 2, int(has_z),
                *(q.data_ptr() for q in qs), R, nbcov, K, out.data_ptr())
    return out


def _open_count_packed(frag_pep8, starts, lens, row_spec, row_i0, row_i1,
                       row_maxz, *, F, Wc, Pk, Z, chunked, nbcov, n_pep, K):
    """The count core in the fused merge's [R, 2K+2] layout: the entry
    gather, the sort, the run-count top-K."""
    W = Wc * V_ROW if chunked else F
    # the sort kernels sort rows up to MAX_F keys of the packed key; past
    # that, or for peptide ids past its 25 bits, torch.sort sorts -pep
    # keys, as the JAX package takes lax.sort there
    packed = use_pallas_sort(W, n_pep)
    keys, z_of, live = open_entries(frag_pep8, starts, lens, F=F, Wc=Wc,
                                    Pk=Pk, Z=Z, nbcov=nbcov, chunked=chunked,
                                    packed=packed)
    # Sort each entry row by peptide DESCENDING; invalid entries go to the
    # tail, so the count reads only the first F columns (F > any true
    # entry count). Inside one peptide's run the entries' order may
    # differ between the two sorts, which changes no count: runs are
    # delimited by peptide boundaries and the z mask is per entry. A sort
    # moves no key past the no-entry keys, so each row's live count is
    # its sorted row's live prefix.
    if packed:
        rows, z_sorted = bitonic_sort_rows(keys), None
    else:
        rows, order = torch.sort(keys, dim=1, stable=True)
        z_sorted = (None if z_of is None
                    else torch.gather(z_of, 1, order[:, :F]))
    return open_count(rows, z_sorted, live, row_spec, row_i0, row_i1,
                      row_maxz, F=F, K=K, nbcov=nbcov, Z=Z, packed=packed)


def _open_count_core(frag_pep8, starts, lens, row_spec, row_i0, row_i1,
                     row_maxz, *, F, Wc, Pk, Z, K, R, chunked, nbcov=1,
                     n_pep):
    """Peak-major preliminary count. Returns (vals [R, K], cand [R, K],
    matched_total [R], scored [R]), all i32: views of
    :func:`_device_open_count`'s packed rows."""
    packed = _open_count_packed(
        frag_pep8, starts, lens, row_spec, row_i0, row_i1, row_maxz, F=F,
        Wc=Wc, Pk=Pk, Z=Z, chunked=chunked, nbcov=nbcov, n_pep=n_pep, K=K)
    return (packed[:, :K], packed[:, K:2 * K], packed[:, 2 * K],
            packed[:, 2 * K + 1])


def _device_open_count(frag_pep8, starts, lens, row_spec, row_i0, row_i1,
                       row_maxz, *, F, Wc, Pk, Z, K, R, chunked, nbcov=1,
                       n_pep):
    """The peak-major preliminary count in the fused merge's i32
    [R, 2K+2] layout (vals, cand, matched_total, scored)."""
    return _open_count_packed(
        frag_pep8, starts, lens, row_spec, row_i0, row_i1, row_maxz, F=F,
        Wc=Wc, Pk=Pk, Z=Z, chunked=chunked, nbcov=nbcov, n_pep=n_pep, K=K)


def range_tables(frag_mz, band_off, device):
    """Device tables of the range search for masses ``frag_mz`` sorted by
    (band, m/z), band b holding [band_off[b], band_off[b + 1]): a
    band-aligned 64-lane copy of the masses (+inf padded, one all-inf
    guard row), the per-band 64x decimation viewed as [nb, DEC2, 64]
    groups with their 4096x decimation (each group's last value), and the
    per-band row offsets, lengths, flat offsets and first/last masses.
    The kernel reads the copy, offsets, lengths and first/last masses;
    the plain probe reads the decimations too."""
    off = np.asarray(band_off, np.int64)
    nb = off.size - 1
    lens_b = np.diff(off)
    rows_b = -(-lens_b // 64)
    row_off = np.concatenate([[0], np.cumsum(rows_b)]).astype(np.int64)
    R64 = int(row_off[-1]) + 1  # +1 all-inf guard row
    mz64 = np.full((R64, 64), np.inf, np.float32)
    dec_n = max(int(rows_b.max(initial=1)), 1)
    DEC2 = -(-dec_n // 64)
    dec = np.full((nb, DEC2 * 64), np.inf, np.float32)
    for b in range(nb):
        seg = frag_mz[off[b]: off[b + 1]]
        r0, r1 = row_off[b], row_off[b + 1]
        flat = mz64[r0:r1].reshape(-1)
        flat[: seg.size] = seg
        mz64[r0:r1] = flat.reshape(-1, 64)
        dec[b, : rows_b[b]] = mz64[r0:r1, 63]
    decg = dec.reshape(nb, DEC2, 64)
    bfirst = np.full(nb, np.inf, np.float32)
    blast = np.full(nb, -np.inf, np.float32)
    ne = lens_b > 0
    bfirst[ne] = frag_mz[off[:-1][ne]]
    blast[ne] = frag_mz[off[1:][ne] - 1]

    def dev(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    return (dev(mz64), dev(decg), dev(decg[:, :, 63]), dev(row_off[:-1]),
            dev(lens_b.astype(np.int64)), dev(off[:-1].astype(np.int64)),
            dev(bfirst), dev(blast))


class OpenSearcher:
    """Peak-major preliminary counts against the flat sorted fragment
    index. Built once per Scorer; between batches it keeps the
    device-resident tables and the sticky static shapes."""

    # device-memory budget for the [B, F] entry matrices; batches whose
    # (spectra x max entries) footprint exceeds it are split. The JAX
    # package's value, so both plan the same batches.
    MAX_ELEMENTS = 128 << 20

    def _auto_bands(self, db, precursor_tol) -> int:
        """Band count for the (band, m/z)-sorted layout: the largest
        power of two (at most 64) that keeps the expected banded window
        near 32 entries; 1 (unbanded) when a window covers most of the
        table anyway. Counting masks by exact [i0, i1) per row, so the
        band count never changes results."""
        mono = db.table.mono
        span = float(mono[-1] - mono[0]) if len(db) > 1 else 1.0
        if precursor_tol is not None and span > 0:
            mid = float(mono[len(db) // 2])
            lo, hi = precursor_tol.bounds(np.float32(mid))
            frac = min(max((float(hi) - float(lo)) / span, 0.01), 1.0)
        else:
            frac = 1.0
        t = self.frag_tol
        if t.kind == "ppm":
            wfrac = (float(t.hi) - float(t.lo)) * 1e-6
        else:  # Da/pct: window width as a fraction of a ~1000 m/z range
            lo, hi = t.bounds(np.float32(1000.0))
            wfrac = (float(hi) - float(lo)) / 1000.0
        est_len = db.num_fragments * wfrac
        target = max(est_len / 32.0, 1.0)
        nb = 1
        while nb < 64 and nb < target:
            nb *= 2
        # banding only pays when it actually skips entries
        if frac + 2.0 / nb >= 0.7:
            nb = 1
        return nb

    def __init__(self, db, frag_tol, Z: int, K: int = 50,
                 precursor_tol=None, *, device):
        assert db.fragment_mz_flat is not None
        self.frag_tol = frag_tol
        self.device = torch.device(device)
        n = db.fragment_pep_flat.shape[0]
        n_pep = len(db)
        self.n_pep = n_pep
        env = os.environ.get("SAGE_TPU_OPEN_BANDS")
        nb = int(env) if env else self._auto_bands(db, precursor_tol)
        nb = max(min(nb, max(n_pep, 1)), 1)
        self.n_bands = nb
        self.band_w = max(-(-n_pep // nb), 1)
        pep_flat = db.fragment_pep_flat.astype(np.int32)
        if nb > 1:
            band = pep_flat // np.int32(self.band_w)
            # stable sort by band keeps the m/z order within each band
            order = np.argsort(band, kind="stable")
            self.frag_mz = db.fragment_mz_flat[order]
            pep_b = pep_flat[order]
            counts = np.bincount(band, minlength=nb)
            self.band_off = np.concatenate(
                [[0], np.cumsum(counts)]
            ).astype(np.int64)
        else:
            self.frag_mz = db.fragment_mz_flat
            pep_b = pep_flat
            self.band_off = np.array([0, n], np.int64)
        n_pad = max(((n + V_ROW - 1) // V_ROW) * V_ROW, 2 * V_ROW)
        pep_pad = np.full(n_pad, -1, np.int32)
        pep_pad[:n] = pep_b
        # [N/V, V] view for the row-aligned gather
        self.frag_pep8_dev = torch.from_numpy(
            pep_pad.reshape(-1, V_ROW)).to(self.device)
        self.Z = Z
        self.K = K
        self._dev_rng = None  # device range-probe tables, built lazily
        self._sticky_shapes = None  # learned static shapes (note_shapes)
        self._est_hist = None

    def _qoct_F(self, v: int) -> int:
        F = _quarter_octave(int(v) + 64)
        return ((max(F, self.K, 128) + 127) // 128) * 128

    def note_shapes(self, chunked: bool, Wc: int, max_total: int,
                    slot_sizes=None, slot_ests=None, slot_valid=None,
                    slot_rows=None):
        """Record quarter-octave STICKY static shapes from a host-planned
        batch; every later batch then plans its ranges on the device
        under them. A 1.25x margin over the observed maxima absorbs
        batch-to-batch variation; violations are detected on the device
        and grown (grow_shapes).

        With the per-(spectrum, covered band) slot totals, entry
        estimates and row totals of the teaching batch, up to 3 SLOT SIZE
        CLASSES are recorded (p50, p85, max), and alpha calibrates the
        host density estimate to slot sizes (p95 of size / estimate)."""
        Wc_s = _quarter_octave(max(int(Wc * 1.25), 8))
        F_top = self._qoct_F(int(max_total * 1.25))
        classes = [{"Wc": Wc_s, "F": F_top}]
        alpha = None
        if slot_sizes is not None and slot_valid is not None:
            sv = slot_sizes[slot_valid].astype(np.float64)
            ev = (
                slot_ests[slot_valid].astype(np.float64)
                if slot_ests is not None else None
            )
            rv = (
                slot_rows[slot_valid].astype(np.float64)
                if slot_rows is not None else None
            )
            if sv.size >= 64 and ev is not None and np.all(ev > 0):
                F_max = self._qoct_F(int(sv.max(initial=0) * 1.25))
                s50 = self._qoct_F(int(np.percentile(sv, 50) * 1.25))
                s85 = self._qoct_F(int(np.percentile(sv, 85) * 1.25))
                cl = []
                for F_c in (s50, s85, F_max):
                    if cl and F_c <= cl[-1]["F"]:
                        continue
                    if rv is not None and rv.size:
                        in_c = sv * 1.25 <= F_c
                        wc_c = _quarter_octave(max(
                            int(rv[in_c].max(initial=8) * 1.25), 8
                        ))
                    else:
                        wc_c = Wc_s
                    cl.append({"Wc": min(wc_c, Wc_s), "F": F_c})
                if len(cl) > 1:
                    classes = cl
                    alpha = float(np.percentile(sv / ev, 95))
        self._sticky_shapes = {
            "chunked": bool(chunked),
            "classes": classes,
            "alpha": alpha,
            # the single-shape view (top class)
            "Wc": classes[-1]["Wc"],
            "F": classes[-1]["F"],
        }

    def grow_shapes(self, tot_e: int, tot_r: int, ci: int = -1):
        """Grow class ``ci``'s sticky shapes after a device-detected
        violation, and raise alpha so borderline slots move up a class.
        Growth never shrinks any class."""
        st = self._sticky_shapes
        cl = st["classes"][ci]
        cl["F"] = max(self._qoct_F(int(tot_e * 1.25)), cl["F"])
        cl["Wc"] = max(
            _quarter_octave(max(int(tot_r * 1.25), 8)), cl["Wc"]
        )
        if st.get("alpha"):
            st["alpha"] *= 1.15
        st["Wc"] = max(st["Wc"], st["classes"][-1]["Wc"])
        st["F"] = max(st["F"], st["classes"][-1]["F"])

    def est_band_sizes(self, masses: np.ndarray, u0, u1):
        """Per-(spectrum, covered band slot) entry-total estimate ([B,
        nbcov] f64) and the live-slot mask, from a per-band 1-Da fragment
        density histogram times each peak's tolerance width. Used only
        for size-class membership: each class's capacity is checked on
        the device, so a bad estimate costs time, never correctness."""
        nb = self.n_bands
        if self._est_hist is None:
            mz = self.frag_mz
            hi = int(min(float(mz[-1] if mz.size else 1.0), 39000.0)) + 2
            H2 = np.zeros((nb, hi + 1), np.float32)
            off = self.band_off
            for b in range(nb):
                seg = self.frag_mz[off[b]: off[b + 1]]
                if seg.size:
                    H2[b] = np.bincount(
                        np.clip(seg.astype(np.int64), 0, hi),
                        minlength=hi + 1,
                    )
            self._est_hist = H2
        H2 = self._est_hist
        B, Pk = masses.shape
        m = np.where(np.isfinite(masses), masses, 0.0)
        idx = np.clip(m.astype(np.int64), 0, H2.shape[1] - 1)
        t = self.frag_tol
        if t.kind == "ppm":
            width = m * np.float64((float(t.hi) - float(t.lo)) * 1e-6)
        else:
            width = np.full((B, Pk), float(t.hi) - float(t.lo))
        b0, b1, nbcov = covered_bands(u0, u1, self.band_w, nb, B)
        bands = np.clip(
            b0[:, None] + np.arange(nbcov)[None, :], 0, nb - 1
        )  # [B, nbcov]
        valid = (b0[:, None] + np.arange(nbcov)[None, :]) <= b1[:, None]
        dens = H2[bands[:, :, None], idx[:, None, :]]  # [B, nbcov, Pk]
        est_band = (
            (dens * np.maximum(width, 0.0)[:, None, :]).sum(axis=2)
        ).astype(np.float64)
        return np.maximum(est_band, 1.0), valid

    def assign_classes(self, ests: np.ndarray):
        """Class index per slot under the sticky classes: the smallest
        class whose F covers 1.25 * alpha * est. None when the sticky
        state has a single class (or no calibration)."""
        st = self._sticky_shapes
        if not st or len(st.get("classes", ())) <= 1 or not st.get("alpha"):
            return None
        pred = st["alpha"] * ests * 1.25
        ci = np.zeros(ests.shape, np.int64)
        for c, cl in enumerate(st["classes"][:-1]):
            ci[pred > cl["F"]] = c + 1
        return ci

    def _dev_ranges_tables(self):
        """The device tables of the range search (:func:`range_tables`),
        built once."""
        if self._dev_rng is None:
            self._dev_rng = range_tables(self.frag_mz, self.band_off,
                                         self.device)
        return self._dev_rng

    def _tol(self):
        t = self.frag_tol
        return (t.kind, float(t.lo), float(t.hi))

    def ranges_device(self, peaks_dev, u0, u1, Zb: int):
        """Device (starts, lens), laid out and valued exactly as
        :meth:`ranges`, with no host search and no ranges upload; plus
        nbcov."""
        B = int(peaks_dev.shape[1])
        nb = self.n_bands
        b0, b1, nbcov = covered_bands(u0, u1, self.band_w, nb, B)
        bands = b0[:, None] + np.arange(nbcov)[None, :]
        valid = bands <= b1[:, None]
        bands_c = np.clip(bands, 0, nb - 1)
        st, ln = _device_ranges(
            self._dev_ranges_tables(), peaks_dev,
            torch.from_numpy(bands_c).to(self.device),
            torch.from_numpy(valid).to(self.device), Zb=Zb, tol=self._tol(),
        )
        return st, ln, nbcov

    def ranges_device_slots(self, peaks_dev, slot_spec, slot_band,
                            slot_valid, Zb: int):
        """Slot-major device ranges for an explicit slot list (host
        arrays); padding slots pass slot_valid False and come back all
        zero."""
        def dev(a, dt):
            return torch.from_numpy(np.asarray(a, dt)).to(self.device)

        return _device_ranges_flat(
            self._dev_ranges_tables(), peaks_dev,
            dev(slot_spec, np.int64), dev(slot_band, np.int64),
            dev(slot_valid, bool), Zb=Zb, tol=self._tol(),
        )

    def planning_ranges(self, masses: np.ndarray, Zb: int, u0, u1):
        """The host planning's (starts, lens), laid out and valued as
        :meth:`ranges`: on a card the range search kernel computes them
        from the uploaded masses (:meth:`ranges_device`) and they are
        fetched; on the CPU :meth:`ranges` searches on the host."""
        if self.device.type != "cuda":
            return self.ranges(masses, Zb, u0, u1)
        peaks = torch.from_numpy(
            np.ascontiguousarray(masses, np.float32)[None]).to(self.device)
        st, ln, _ = self.ranges_device(peaks, u0, u1, Zb)
        return st.cpu().numpy(), ln.cpu().numpy()

    def ranges(
        self, masses: np.ndarray, Zb: int,
        u0: np.ndarray = None, u1: np.ndarray = None,
    ) -> Tuple[np.ndarray, np.ndarray]:
        """Host: [B, Zb*nbcov*Pk] range starts/lengths of every (z,
        covered band, peak) window over the band-segmented sorted fragment
        m/z array; only bands that meet each spectrum's precursor union
        [u0, u1) are searched. +inf padding peaks give NaN/inf bounds and
        empty ranges."""
        B, Pk = masses.shape
        nb = self.n_bands
        b0, b1, nbcov = covered_bands(u0, u1, self.band_w, nb, B)
        starts = np.zeros((B, Zb * Pk * nbcov), np.int32)
        lens = np.zeros((B, Zb * Pk * nbcov), np.int32)
        off = self.band_off
        for zi in range(Zb):
            q = (masses * F32(zi + 1)).astype(np.float32)
            with np.errstate(invalid="ignore"):
                lo, hi = self.frag_tol.bounds(q)
            bad = ~np.isfinite(lo) | ~np.isfinite(hi)
            for b in range(nb):
                sel = np.flatnonzero((b0 <= b) & (b <= b1))
                if sel.size == 0:
                    continue
                seg = self.frag_mz[off[b]: off[b + 1]]
                if seg.size == 0:
                    continue
                # only windows that meet the band's m/z span are searched
                glo = lo[sel]
                ghi = hi[sel]
                hit = ~bad[sel] & (ghi >= seg[0]) & (glo <= seg[-1])
                s = np.zeros(glo.shape, np.int64)
                e = np.zeros(glo.shape, np.int64)
                if hit.any():
                    s[hit] = np.searchsorted(seg, glo[hit], side="left")
                    e[hit] = np.searchsorted(seg, ghi[hit], side="right")
                    s[hit] += off[b]
                    e[hit] += off[b]
                # window column: z-major, then band slot, then peak
                j = (b - b0[sel]).astype(np.int64)
                col = (zi * nbcov + j[:, None]) * Pk + np.arange(Pk)
                starts[sel[:, None], col] = s.astype(np.int32)
                lens[sel[:, None], col] = np.maximum(e - s, 0).astype(
                    np.int32
                )
        return starts, lens

    def _geometry(self, masses, rows, Zb, _ranges):
        """Host planning of an open batch: band-aware window ranges, the
        gather layout and the padded static shapes, all per (spectrum,
        covered band). Returns (starts, lens, Pk, chunked, size, Wc, F,
        nbcov)."""
        B, Pk = masses.shape
        if _ranges is None:
            u0, u1 = spectrum_window_union(rows, B)
            starts, lens = self.planning_ranges(masses, Zb, u0, u1)
        else:
            starts, lens = _ranges
        nbcov = starts.shape[1] // max(Zb * Pk, 1)
        # entry layout: row-aligned gather when windows are long, ragged
        # flat gather otherwise
        n_win = max(int((lens > 0).sum()), 1)
        chunked = float(lens.sum()) / n_win >= 48.0
        ends = starts + lens
        rows_w = np.where(
            lens > 0, (ends + (V_ROW - 1)) // V_ROW - starts // V_ROW, 0
        )
        # per-(spectrum, band) totals: window axis layout (z, band, pk)
        tc_sb = rows_w.reshape(B, Zb, nbcov, Pk).sum(axis=(1, 3))
        tot_sb = lens.reshape(B, Zb, nbcov, Pk).sum(axis=(1, 3))
        # per-spectrum densest band (sets F; the split peels on it)
        size = (tc_sb * V_ROW if chunked else tot_sb).max(axis=1)
        Wc = _quarter_octave(max(int(tc_sb.max()), 8)) if chunked else 8
        # F strictly above any (spectrum, band)'s entry count, at least K
        F = _quarter_octave(int(max(tot_sb.max(), 1)) + 1)
        F = ((max(F, self.K, 128) + 127) // 128) * 128
        if chunked:
            F = min(F, Wc * V_ROW)
        return starts, lens, Pk, chunked, size, Wc, F, nbcov

    def _find_split(self, B, size, nbcov=1):
        """Sub-batch split mask, or None: halve over the element budget;
        otherwise peel the light part off a heavily skewed batch (the
        sort axis pads every spectrum to the densest one)."""
        if B <= 1:
            return None
        F_est = int(size.max()) + 1
        if B * nbcov * F_est > self.MAX_ELEMENTS:
            return np.arange(B) < B // 2
        if B >= 128:
            p75 = _quarter_octave(max(int(np.percentile(size, 75)), 1))
            if _quarter_octave(F_est) > 2 * p75:
                split = size <= p75
                if 0 < split.sum() < B:
                    return split
        return None

    @staticmethod
    def _sub_batches(split, rows, maxz):
        """Iterate the two sides of a split: yields (spec_ids, rsel,
        sub_rows, mz_sub, R_sub, n_sub) with spectrum indices remapped
        order-preservingly and the rows padded to a power of two."""
        si = rows["si"]
        n_rows = si.size
        maxz_rows = maxz[:n_rows]
        B = split.shape[0]
        for sel in (split, ~split):
            spec_ids = np.flatnonzero(sel)
            remap = np.full(B, -1, np.int64)
            remap[spec_ids] = np.arange(spec_ids.size)
            rsel = sel[si]
            sub_rows = {
                k: (
                    remap[v[rsel]].astype(v.dtype) if k == "si" else v[rsel]
                )
                for k, v in rows.items()
            }
            n_sub = int(rsel.sum())
            R_sub = 8
            while R_sub < n_sub:
                R_sub *= 2
            mz_sub = np.full(R_sub, 2, np.int32)
            mz_sub[:n_sub] = maxz_rows[rsel]
            yield spec_ids, rsel, sub_rows, mz_sub, R_sub, n_sub

    def preliminary_packed(
        self, masses: np.ndarray, rows: Dict[str, np.ndarray],
        maxz: np.ndarray, R: int, Zb: int, _ranges=None,
    ):
        """The two-dispatch path's preliminary counts: the packed i32
        [R, 2K+2] layout for the query rows ``rows`` (maxz [R]), as a
        device tensor, or as a host array when the batch was split into
        spectrum sub-batches over the element budget (recursively, at any
        depth; the ranges are computed once and sliced through the
        recursion, and each side is fetched before it is written into the
        parent's rows)."""
        B = masses.shape[0]
        starts, lens, Pk_eff, chunked, size, Wc, F, nbcov = self._geometry(
            masses, rows, Zb, _ranges
        )
        split = self._find_split(B, size, nbcov)
        if split is not None:
            out = np.zeros((R, 2 * self.K + 2), np.int32)
            for spec_ids, rsel, sub_rows, mz_sub, R_sub, n_sub in (
                self._sub_batches(split, rows, maxz)
            ):
                sub = self.preliminary_packed(
                    masses[spec_ids], sub_rows, mz_sub, R_sub, Zb,
                    _ranges=(starts[spec_ids], lens[spec_ids]),
                )
                if isinstance(sub, torch.Tensor):
                    sub = sub.cpu().numpy()
                out[np.flatnonzero(rsel)] = sub[:n_sub]
            return out
        n_rows = rows["si"].size
        ints = np.zeros((3, R), np.int32)  # spectrum, i0, i1
        ints[0, :n_rows] = rows["si"]
        ints[1, :n_rows] = rows["i0"]
        ints[2, :n_rows] = rows["i1"]

        def dev(a):
            return torch.from_numpy(np.ascontiguousarray(a)).to(self.device)

        return _device_open_count(
            self.frag_pep8_dev, dev(starts), dev(lens), dev(ints[0]),
            dev(ints[1]), dev(ints[2]), dev(maxz),
            F=F, Wc=Wc, Pk=Pk_eff, Z=Zb, K=self.K, R=R, chunked=chunked,
            nbcov=nbcov, n_pep=self.n_pep,
        )
