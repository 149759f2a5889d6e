"""Multi-device search: the scoring step sharded over a ("data", "model")
grid of devices, driven from one process.

Counterpart of ``sage_tpu/parallel/sharding.py``:

* **Data parallelism**: a batch's query rows (spectrum x charge x
  isotope) are split into ``n_data`` contiguous blocks, one per row of
  the grid.
* **Model parallelism**: the mass-sorted peptide table is split into
  ``n_model`` equal ranges of ``P_local`` rows, one per column of the
  grid; each shard holds its range's ion ladders (and, for the open
  search, the fragment index entries of its peptides). Every shard
  counts its block's rows against its range, keeps a per-row top-K, and
  the shards of a row of the grid merge their top-Ks (count desc,
  peptide desc: PreScore Ord, scoring.rs:43-49). Stage 2 is
  owner-computes: each shard rescores the merged candidates whose
  peptides it holds and zeros elsewhere, and a sum over the shards
  assembles the features.

Where the JAX package runs one ``shard_map`` program, the port runs one
controller over a grid of ``torch.device``s: each shard's tensors live on
its own device, and the three collectives of ``shard_map`` are small
functions over the shards' tensors that reduce in one fixed order on the
merging device (the grid row's first device): :func:`all_gather` (copy
each model shard's ``[R_l, K]`` there), :func:`psum` (integer sums, and
f32 sums with exactly one non-zero shard per item, exact in any order)
and :func:`pmax`. No process group is needed, and a device may stand in
the grid more than once: four shards on one card run one after another.
Copies between cards wait on an event recorded on the source's stream.

On a CUDA shard the stage-1 count of the windowed (narrow) and
whole-table steps is the stage-1 kernel (``csrc/stage1_counts.cu``) on
the shard's ladders, and the banded open step's count core sorts its
entry rows with the row-sort or cluster-sort kernel, as on one device.
Results are bitwise independent of the grid's shape. A zero-count slot
of a step's top-K names no peptide (-1); no output reads it.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from ..chem.mass import Tolerance
from ..index.builder import IndexedDatabase, next_power_of_two
from ..ops.open_search import (
    V_ROW,
    OpenSearcher,
    _device_ranges,
    _open_count_core,
    _quarter_octave,
    range_tables,
)
from ..ops.batch_prep import BatchColumns
from ..ops.pallas_stage1 import stage1_counts
from ..ops.search import (
    _DeviceTables,
    _tol_tuple,
    _topk_layout,
    rescore_indexed,
)

# the widest candidate tile of one stage-1 launch in the whole-table
# step (its candidate list takes 4 bytes a slot of shared memory)
FULL_TILE = 8192


def _norm(device) -> torch.device:
    d = torch.device(device)
    if d.type == "cuda" and d.index is None:
        d = torch.device("cuda", torch.cuda.current_device())
    return d


def local_devices(device="cuda") -> List[torch.device]:
    """The devices this process can mesh: every visible card when it runs
    on CUDA (the default; with no card this raises), else ``device``
    alone (the CPU, when the caller asks for it)."""
    device = torch.device(device)
    if device.type != "cuda":
        return [device]
    if not torch.cuda.is_available():
        raise RuntimeError(
            "local_devices: no CUDA device is available; pass "
            "device='cpu' to mesh the CPU"
        )
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


@dataclasses.dataclass
class Mesh:
    """An ``n_data x n_model`` grid of devices."""

    devices: List[List[torch.device]]

    @property
    def shape(self) -> Dict[str, int]:
        return {"data": len(self.devices), "model": len(self.devices[0])}


def make_mesh(n_data: int, n_model: int,
              devices: Optional[Sequence] = None) -> Mesh:
    """A ("data", "model") grid over the given devices, or over
    :func:`local_devices` (the cards). An explicit list may name a device
    more than once (shards then share it); too few devices raise."""
    devices = list(devices if devices is not None else local_devices())
    n = n_data * n_model
    if n < 1 or len(devices) < n:
        raise ValueError(f"need {n} devices, have {len(devices)}")
    devs = [_norm(d) for d in devices[:n]]
    return Mesh([devs[d * n_model:(d + 1) * n_model] for d in range(n_data)])


# ----------------------------------------------------------------------
# Collectives over the shards of one grid row
# ----------------------------------------------------------------------


def _copy_to(t: torch.Tensor, device: torch.device) -> torch.Tensor:
    """``t`` on ``device``. Between two cards the copy is ordered after
    the work that made ``t``: the destination's stream waits on an event
    recorded on the source's current stream."""
    if t.device == device:
        return t
    if t.device.type == "cuda" and device.type == "cuda":
        ev = torch.cuda.Event()
        ev.record(torch.cuda.current_stream(t.device))
        torch.cuda.current_stream(device).wait_event(ev)
        with torch.cuda.device(device):
            return t.to(device)
    return t.to(device)


def all_gather(parts: Sequence[torch.Tensor], device) -> torch.Tensor:
    """The model shards' ``[R_l, K]`` tensors side by side on ``device``:
    ``[R_l, n_model * K]``, shard order."""
    return torch.cat([_copy_to(p, device) for p in parts], dim=1)


def psum(parts: Sequence[torch.Tensor], device) -> torch.Tensor:
    """The shards' tensors summed on ``device``, shard 0 first. Integer
    sums are exact; the f32 features are non-zero on one shard per item
    (owner computes), so their sum is that shard's value."""
    acc = _copy_to(parts[0], device)
    for p in parts[1:]:
        acc = acc + _copy_to(p, device)
    return acc


def pmax(parts: Sequence[torch.Tensor], device) -> torch.Tensor:
    """The elementwise max of the shards' tensors on ``device``."""
    return torch.stack([_copy_to(p, device) for p in parts]).amax(dim=0)


def merge_topk(vals: torch.Tensor, pep: torch.Tensor, K: int):
    """Top-K of i32 ``vals``/``pep`` [R, N] (N >= K) by (count desc,
    peptide desc), the two-key order of the JAX package's merge; -1
    marks a slot with no peptide. One int64 key a slot, so the order is
    exact for any table size."""
    key = (vals.long() << 32) | (pep.long() + 1)
    top = torch.topk(key, K, dim=1).values
    return (top >> 32).to(torch.int32), ((top & 0xFFFFFFFF) - 1).to(
        torch.int32)


def _row_topk(counts, p0, W: int, K: int, base: int):
    """Per-row top-K of a stage-1 output [n, W + 2] (count desc, peptide
    desc; ties go to the higher peptide, as ``lax.top_k`` on the reversed
    axis): vals i32 [n, K], global peptide ids (-1 where the count is 0)
    and the matched total and scored count of each row."""
    k = min(K, W)
    out = _topk_layout(counts, p0, W, k)
    vals, pep = out[:, :k], out[:, k:2 * k] + base
    if k < K:
        n = vals.shape[0]
        vals = torch.cat([vals, vals.new_zeros((n, K - k))], dim=1)
        pep = torch.cat([pep, pep.new_full((n, K - k), -1)], dim=1)
    return (vals, torch.where(vals > 0, pep, -1), out[:, 2 * k],
            out[:, 2 * k + 1])


# ----------------------------------------------------------------------
# Tables
# ----------------------------------------------------------------------


class ShardedTables:
    """The peptide table split over "model" and repeated over "data".
    ``P_pad`` is ``sage_tpu``'s: ``max(next_pow2(n_pep), 8 * n_model)``
    rounded up to a multiple of ``n_model``, so that ``P_local``, the
    windowed step's ``W <= P_local`` gate and the open index's owner rule
    decide the same way in both packages. Each (device, model shard)
    pair builds its ladders once: shards on one device in one column
    share them."""

    def __init__(self, db: IndexedDatabase, mesh: Mesh, series,
                 min_ion_index):
        n_pep = len(db)
        n_model = mesh.shape["model"]
        P_pad = max(next_power_of_two(max(n_pep, 1)), 8 * n_model)
        self.P_pad = -(-P_pad // n_model) * n_model
        self.P_local = self.P_pad // n_model
        self.P_real = n_pep
        self.L = db.table.max_len
        # the whole table's masses, +inf padded (host): the whole-table
        # step's mass membership
        self.mono = np.pad(db.table.mono.astype(np.float32),
                           (0, self.P_pad - n_pep), constant_values=np.inf)
        built: Dict[tuple, _DeviceTables] = {}
        self.shards = []
        for row in mesh.devices:
            out = []
            for m, dev in enumerate(row):
                key = (str(dev), m)
                if key not in built:
                    built[key] = _DeviceTables(
                        db, series, min_ion_index, dev,
                        rows=(m * self.P_local, self.P_local))
                out.append(built[key])
            self.shards.append(out)


class ShardedSearch:
    """The scoring step over a ("data", "model") grid: stage-1 counts on
    every shard, the top-K merge, and the owner-computes stage 2.

    The step methods take per-row peaks like ``sage_tpu``'s
    (``peaks``/``intens`` f32 [R, Pk], +inf / -1 padded; R divisible by
    the data axis). The ``*_dispatch`` methods take per-spectrum peaks
    [B, Pk] and each row's spectrum ``si`` instead, launch stage 1 and
    the merge, and return a handle; :meth:`step_result` runs stage 2 and
    fetches (counts [R, K], peptide [R, K], mb, my, summed_b, summed_y,
    ppm_sum, longest_b, longest_y, each f32 [R, K], matched_total [R],
    scored [R]) as numpy arrays."""

    def __init__(self, db: IndexedDatabase, mesh: Mesh, frag_tol: Tolerance,
                 Z: int, K: int = 50, min_ion_index: Optional[int] = None):
        self.db = db
        self.mesh = mesh
        self.series = tuple(db.ion_kinds)
        self.min_ion_index = (
            db.min_ion_index if min_ion_index is None else min_ion_index
        )
        self.tables = ShardedTables(db, mesh, self.series,
                                    self.min_ion_index)
        self.frag_tol = frag_tol
        self._tol = _tol_tuple(frag_tol)
        self.Z = Z
        self.K = K
        self._open_tbl = None
        self._open_rng = {}  # model shard -> its range-search tables
        # the most live items one shard rescored in the last stage 2
        # (pmax over the shards)
        self.last_live = 0

    # -- the steps with sage_tpu's signatures ---------------------------

    def __call__(self, peaks, prec_lo, prec_hi, maxz):
        """Stage 1 alone over the whole table: rows' f32 precursor mass
        windows [prec_lo, prec_hi]. Returns (counts [R, K], peptide_idx
        [R, K], matched_total [R], scored [R])."""
        h = self.full_dispatch(*self._per_row(peaks, peaks, prec_lo,
                                              prec_hi, maxz))
        return self._fetch(h, stage2=False)

    def full_step(self, peaks, intens, prec_lo, prec_hi, maxz):
        """Stage 1 over the whole table by f32 mass membership, the
        merge and stage 2."""
        return self.step_result(self.full_dispatch(
            *self._per_row(peaks, intens, prec_lo, prec_hi, maxz)))

    @staticmethod
    def _per_row(peaks, intens, a, b, maxz):
        R = peaks.shape[0]
        return (np.asarray(peaks, np.float32),
                np.asarray(intens, np.float32),
                np.arange(R, dtype=np.int32), np.asarray(a),
                np.asarray(b), np.asarray(maxz, np.int32))

    # -- dispatch ---------------------------------------------------------

    def _blocks(self, R: int):
        n_data = self.mesh.shape["data"]
        assert R % n_data == 0, (R, n_data)
        R_l = R // n_data
        return [slice(d * R_l, (d + 1) * R_l) for d in range(n_data)]

    def _peaks_on(self, h, device):
        """The batch's packed peaks [2, B, Pk] on ``device``, uploaded
        once a device."""
        key = str(device)
        if key not in h["peaks"]:
            h["peaks"][key] = torch.from_numpy(
                np.stack([h["masses"], h["intens"]])).to(device)
        return h["peaks"][key]

    def _launch(self, h, shard_fn):
        """Run ``shard_fn(d, m, device, rows)`` on every shard and merge
        each grid row's results on its first device."""
        K = self.K
        h["merged"] = []
        for d, sl in enumerate(self._blocks(h["si"].size)):
            rows = {k: h[k][sl] for k in ("si", "a", "b", "maxz")}
            parts = [shard_fn(d, m, dev, rows)
                     for m, dev in enumerate(self.mesh.devices[d])]
            mdev = self.mesh.devices[d][0]
            gv, gp = merge_topk(all_gather([p[0] for p in parts], mdev),
                                all_gather([p[1] for p in parts], mdev), K)
            h["merged"].append((
                gv, gp, psum([p[2] for p in parts], mdev),
                psum([p[3] for p in parts], mdev),
            ))
        return h

    def _handle(self, kind, masses, intens, si, a, b, maxz):
        maxz = np.asarray(maxz, np.int32)
        return {"kind": kind, "masses": masses, "intens": intens,
                "si": np.asarray(si, np.int32), "a": a, "b": b,
                "maxz": maxz, "peaks": {},
                "Zb": min(max(int(maxz.max(initial=2)) - 1, 1), self.Z)}

    def _empty(self, R_l, device):
        K = self.K
        return (torch.zeros((R_l, K), dtype=torch.int32, device=device),
                torch.full((R_l, K), -1, dtype=torch.int32, device=device),
                torch.zeros(R_l, dtype=torch.int32, device=device),
                torch.zeros(R_l, dtype=torch.int32, device=device))

    def _count(self, h, d, m, device, rows, lo, hi, W):
        """The stage-1 counts of shard (d, m) over each row's local
        candidate range [lo, hi), in W-wide tiles from lo (one tile where
        the ranges fit W), each tile's top-K merged: i32 (vals [R_l, K],
        pep [R_l, K], matched_total [R_l], scored [R_l])."""
        tab = self.tables.shards[d][m]
        P_local, K = self.tables.P_local, self.K
        base = m * P_local
        R_l = lo.size
        vals, pep, mtot, scored = self._empty(R_l, device)
        span = hi - lo
        n_tiles = -(-int(span.max(initial=0)) // W)
        if n_tiles == 0:
            return vals, pep, mtot, scored
        peaks = self._peaks_on(h, device)[0]
        tv, tp = [], []
        for t in range(n_tiles):
            sel = np.flatnonzero(span > t * W)
            i0 = lo[sel] + t * W
            ints = np.stack([
                rows["si"][sel], np.minimum(i0, P_local - W), i0,
                np.minimum(hi[sel], i0 + W), rows["maxz"][sel],
            ]).astype(np.int32)
            ints_d = torch.from_numpy(ints).to(device)
            counts = stage1_counts(tab.lad_index, peaks, ints_d, W=W,
                                   Lc=tab.L, Z=h["Zb"], tol=self._tol)
            v, p, mt, sc = _row_topk(counts, ints_d[1], W, K, base)
            sel_d = torch.from_numpy(sel).to(device)
            if n_tiles > 1:
                tv.append(torch.zeros_like(vals).index_copy_(0, sel_d, v))
                tp.append(torch.full_like(pep, -1).index_copy_(0, sel_d, p))
            else:
                vals[sel_d], pep[sel_d] = v, p
            mtot.index_add_(0, sel_d, mt)
            scored.index_add_(0, sel_d, sc)
        if n_tiles > 1:
            vals, pep = merge_topk(torch.cat(tv, 1), torch.cat(tp, 1), K)
        return vals, pep, mtot, scored

    def _range_step(self, kind, masses, intens, si, g0, g1, maxz, W: int):
        """Stage 1 over each row's global candidate range [g0, g1): every
        model shard counts the range's local overlap in W-wide launches;
        a row whose range misses the shard counts nothing there and is
        skipped (a zero-count slot never outranks a live one in the
        merge)."""
        P_local = self.tables.P_local
        h = self._handle(kind, masses, intens, si,
                         np.asarray(g0, np.int64), np.asarray(g1, np.int64),
                         maxz)

        def shard(d, m, device, rows):
            base = m * P_local
            lo = np.clip(rows["a"] - base, 0, P_local)
            hi = np.clip(rows["b"] - base, 0, P_local)
            return self._count(h, d, m, device, rows, lo, hi, W)

        return self._launch(h, shard)

    def windowed_dispatch(self, masses, intens, si, i0, i1, maxz, W: int):
        """Stage 1 over each row's [i0, i1) window (W a power of two, at
        least every i1 - i0, at most P_local): one W-wide launch a shard
        from ``p0 = clip(lo_l, 0, P_local - W)`` (``sage_tpu``'s slice),
        or launches of ``FULL_TILE`` candidates where W is wider."""
        assert W <= self.tables.P_local, (W, self.tables.P_local)
        return self._range_step(("win", W), masses, intens, si, i0, i1,
                                maxz, min(W, FULL_TILE))

    def full_dispatch(self, masses, intens, si, prec_lo, prec_hi, maxz):
        """Stage 1 over the whole table: a peptide is a row's candidate
        when ``mono >= lo`` and ``mono <= hi`` in f32, the JAX package's
        membership. On the mass-sorted, +inf-padded table that is one
        contiguous range, which ``searchsorted`` finds exactly; each
        shard counts its part of it in launches of at most
        ``FULL_TILE`` candidates."""
        mono = self.tables.mono
        g0 = np.searchsorted(mono, np.asarray(prec_lo, np.float32), "left")
        g1 = np.maximum(
            np.searchsorted(mono, np.asarray(prec_hi, np.float32), "right"),
            g0)
        span = int((g1 - g0).max(initial=0))
        W = min(next_power_of_two(max(span, 8)), FULL_TILE,
                self.tables.P_local)
        return self._range_step(("full",), masses, intens, si, g0, g1, maxz,
                                W)

    # -- the banded open step: the fragment index split over "model" ------

    def _open_tables(self):
        """Per model shard, the fragment index entries of the peptides it
        owns (``pep // P_local``, the last shard taking any rest), in m/z
        order, padded to a multiple of ``V_ROW`` with -1: the host m/z
        segments (range planning) and, on each of the shard's devices,
        the [N_l / V_ROW, V_ROW] peptide table."""
        if self._open_tbl is None:
            db = self.db
            assert db.fragment_mz_flat is not None, (
                "banded open sharding needs the flat fragment index"
            )
            n_model = self.mesh.shape["model"]
            P_local = self.tables.P_local
            pep = db.fragment_pep_flat.astype(np.int32)
            mz = db.fragment_mz_flat
            shard = np.minimum(pep // np.int32(P_local), n_model - 1)
            order = np.argsort(shard, kind="stable")  # keeps m/z order
            pep_s, mz_s = pep[order], mz[order]
            counts = np.bincount(shard, minlength=n_model)
            offs = np.concatenate([[0], np.cumsum(counts)])
            N_l = max(-(-int(counts.max()) // V_ROW) * V_ROW, 2 * V_ROW)
            segs, tabs = [], {}
            for m in range(n_model):
                pep_pad = np.full(N_l, -1, np.int32)
                pep_pad[:counts[m]] = pep_s[offs[m]:offs[m + 1]]
                segs.append(mz_s[offs[m]:offs[m + 1]])
                for row in self.mesh.devices:
                    key = (str(row[m]), m)
                    if key not in tabs:
                        tabs[key] = torch.from_numpy(
                            pep_pad.reshape(-1, V_ROW)).to(row[m])
            self._open_tbl = (tabs, segs, N_l)
        return self._open_tbl

    def open_ranges(self, masses):
        """Planning: per (shard, spectrum, z, peak) in-tolerance
        fragment ranges over each shard's m/z-sorted segment, the f32
        window semantics of ``OpenSearcher.ranges``. masses: [B, Pk]
        (+inf padded). Returns (starts, lens) i32 [M, B, Z*Pk], host
        arrays: on a card computed by the range search kernel on each
        shard's first device and fetched, on the CPU searched on the
        host."""
        _, segs, _ = self._open_tables()
        if torch.device(self.mesh.devices[0][0]).type == "cuda":
            return self._open_ranges_card(masses, segs)
        M = len(segs)
        B, Pk = masses.shape
        Z = self.Z
        starts = np.zeros((M, B, Z * Pk), np.int32)
        lens = np.zeros((M, B, Z * Pk), np.int32)
        for zi in range(Z):
            q = (masses * np.float32(zi + 1)).astype(np.float32)
            with np.errstate(invalid="ignore"):
                lo, hi = self.frag_tol.bounds(q)
            bad = ~np.isfinite(lo) | ~np.isfinite(hi)
            col = slice(zi * Pk, (zi + 1) * Pk)
            for m in range(M):
                seg = segs[m]
                if seg.size == 0:
                    continue
                hit = ~bad & (hi >= seg[0]) & (lo <= seg[-1])
                s = np.zeros(lo.shape, np.int64)
                e = np.zeros(lo.shape, np.int64)
                if hit.any():
                    s[hit] = np.searchsorted(seg, lo[hit], side="left")
                    e[hit] = np.searchsorted(seg, hi[hit], side="right")
                starts[m, :, col] = s.astype(np.int32)
                lens[m, :, col] = np.maximum(e - s, 0).astype(np.int32)
        return starts, lens

    def _open_ranges_card(self, masses, segs):
        """:meth:`open_ranges` by the range search kernel: each shard's
        segment is one band of its own tables (built once, on the
        shard's device in the first data row)."""
        B, Pk = masses.shape
        starts = np.zeros((len(segs), B, self.Z * Pk), np.int32)
        lens = np.zeros_like(starts)
        for m, seg in enumerate(segs):
            dev = torch.device(self.mesh.devices[0][m])
            tabs = self._open_rng.get(m)
            if tabs is None:
                tabs = self._open_rng[m] = range_tables(
                    seg, np.array([0, seg.size], np.int64), dev)
            peaks = torch.from_numpy(
                np.ascontiguousarray(masses, np.float32)[None]).to(dev)
            st, ln = _device_ranges(
                tabs, peaks, torch.zeros((B, 1), dtype=torch.int64,
                                         device=dev),
                torch.ones((B, 1), dtype=torch.bool, device=dev),
                Zb=self.Z, tol=self._tol)
            starts[m] = st.cpu().numpy()
            lens[m] = ln.cpu().numpy()
        return starts, lens

    def open_F(self, lens) -> int:
        """The entry-row width of a batch: the largest per-(shard,
        spectrum) entry total, on the quarter-octave grid, a multiple of
        128 and at least ``max(K, 128)``."""
        F = _quarter_octave(int(lens.sum(axis=2).max(initial=0)) + 1)
        return ((max(F, self.K, 128) + 127) // 128) * 128

    def open_dispatch(self, masses, intens, si, i0, i1, maxz):
        """The banded open step: each model shard counts its own
        fragment segment with the open search's count core (a peptide's
        entries all live in its owner's segment, so its counts are
        complete there), each data shard only its rows' spectra. Returns
        None when the [B, F] entry rows pass ``MAX_ELEMENTS`` (the caller
        falls back to the whole-table step)."""
        starts, lens = self.open_ranges(masses)
        B, Pk = masses.shape
        F = self.open_F(lens)
        if B * F > OpenSearcher.MAX_ELEMENTS:
            return None
        tabs, _, _ = self._open_tables()
        h = self._handle(("open", B, F), masses, intens, si, np.asarray(i0),
                         np.asarray(i1), maxz)
        n_pep = len(self.db)

        def shard(d, m, device, rows):
            s_lo = int(rows["si"].min())
            s_hi = int(rows["si"].max()) + 1

            def dev(x):
                return torch.from_numpy(np.ascontiguousarray(x)).to(device)

            vals, cand, mtot, scored = _open_count_core(
                tabs[(str(device), m)], dev(starts[m, s_lo:s_hi]),
                dev(lens[m, s_lo:s_hi]), dev(rows["si"] - s_lo),
                dev(rows["a"].astype(np.int32)),
                dev(rows["b"].astype(np.int32)), dev(rows["maxz"]),
                F=F, Wc=8, Pk=Pk, Z=self.Z, K=self.K, R=rows["si"].size,
                chunked=False, n_pep=n_pep,
            )
            return vals, torch.where(vals > 0, cand, -1), mtot, scored

        return self._launch(h, shard)

    # -- stage 2 and the fetch --------------------------------------------

    def _owner_stage2(self, h, d, m, device, gvals, gpep):
        """Owner computes: shard (d, m) rescores the merged live
        (count > 0) items whose peptides it holds, with the full ladders,
        and leaves zeros elsewhere. Returns f32 [7, R_l, K] (mb, my,
        summed_b, summed_y, ppm_sum, longest_b, longest_y) and the live
        item count (a 0-d tensor)."""
        tab = self.tables.shards[d][m]
        base = m * self.tables.P_local
        gvals, gpep = _copy_to(gvals, device), _copy_to(gpep, device)
        live = (gvals > 0) & (gpep >= base) & (gpep < base + tab.P_pad)
        out = torch.zeros((7,) + tuple(gvals.shape), dtype=torch.float32,
                          device=device)
        rows, ks = live.nonzero(as_tuple=True)
        if rows.numel():
            sl = self._blocks(h["si"].size)[d]
            si = torch.from_numpy(h["si"][sl]).to(device)
            maxz = torch.from_numpy(h["maxz"][sl]).to(device)
            peaks = self._peaks_on(h, device)
            feats = rescore_indexed(
                tab.lad_full, (gpep[rows, ks] - base).to(torch.int32)[:, None],
                si[rows].to(torch.int32), peaks[0], peaks[1],
                maxz[rows].to(torch.int32)[:, None],
                series=self.series, frag_tol=self._tol, Z=h["Zb"],
            )
            out[:, rows, ks] = torch.stack(
                [f[:, 0].to(torch.float32) for f in feats])
        return out, live.sum()

    def _fetch(self, h, stage2: bool):
        outs = []
        live = []
        for d, (gv, gp, mt, sc) in enumerate(h["merged"]):
            mdev = self.mesh.devices[d][0]
            block = [gv, gp]
            if stage2:
                parts = [self._owner_stage2(h, d, m, dev, gv, gp)
                         for m, dev in enumerate(self.mesh.devices[d])]
                feats = psum([p[0] for p in parts], mdev)
                live.append(pmax([p[1] for p in parts], mdev))
                block += list(feats)
            outs.append([x.cpu().numpy() for x in block + [mt, sc]])
        if stage2:
            self.last_live = max(int(x) for x in live)
        return tuple(np.concatenate(c) for c in zip(*outs))

    def step_result(self, h):
        """Stage 2 of a dispatched step and the fetch: the 11 result
        arrays. Every live item is rescored (the JAX package's item
        budget and its redo exist for XLA's static shapes)."""
        return self._fetch(h, stage2=True)

    # -- candidate-list rescore (chimera rounds) ---------------------------

    def rescore(self, masses, intens, spec, pep, maxz):
        """Owner-computes rescore of an explicit candidate list: item i
        is peptide ``pep[i]`` (global index) against spectrum
        ``spec[i]``'s peaks ``masses``/``intens`` [B, Pk] with the
        exclusive fragment-charge bound ``maxz[i]``. Items are split over
        "data", each model shard rescores the items it owns, and a sum
        over "model" assembles them. Returns f32 [C, 7]."""
        n_data = self.mesh.shape["data"]
        nI = int(np.asarray(spec).size)
        C = max(-(-nI // n_data), 1) * n_data
        h = self._handle(("rescore",), masses, intens,
                         np.pad(np.asarray(spec, np.int32), (0, C - nI)),
                         None, None, np.pad(maxz, (0, C - nI),
                                            constant_values=2))
        pep_c = np.pad(np.asarray(pep, np.int32), (0, C - nI),
                       constant_values=-1)
        outs = []
        for d, sl in enumerate(self._blocks(C)):
            mdev = self.mesh.devices[d][0]
            gp = torch.from_numpy(pep_c[sl]).to(mdev)[:, None]
            # every listed candidate is live; padding (-1) is owned by none
            parts = [self._owner_stage2(h, d, m, dev, (gp >= 0).int(), gp)[0]
                     for m, dev in enumerate(self.mesh.devices[d])]
            outs.append(psum(parts, mdev)[:, :, 0].T.cpu().numpy())
        return np.concatenate(outs)[:nI]


class ShardedScorer:
    """``score_table(spectra)`` over a ("data", "model") grid, producing
    the single-device ``Scorer``'s FeatureTable bit for bit, for any grid
    shape.

    The host expands (spectrum x charge x isotope) query rows, the grid
    runs one step (windowed, banded open or whole-table), and the
    single-device Scorer's host machinery (built without tables) merges
    the candidates and assembles the columns."""

    def __init__(self, db: IndexedDatabase, mesh: Mesh, params):
        from ..ops.search import Scorer

        self.db = db
        self.mesh = mesh
        self.params = params
        self._host = h = Scorer(db, params, build_device_tables=False)
        self.search = ShardedSearch(db, mesh, params.fragment_tol, Z=h.Z,
                                    K=h.K)
        self._n_data = mesh.shape["data"]
        # the step kind of the last batch ("win", "open", "full")
        self.last_route = None

    def score_stream(self, batches):
        """Drop-in for ``Scorer.score_stream``: up to two batches in
        flight through the shared driver; chimeric search one batch at a
        time (its rounds depend on each other)."""
        from ..ops.search import pipeline_stream

        if self.params.chimera:
            for batch in batches:
                yield self.score_table(batch)
            return
        yield from pipeline_stream(
            batches, self._dispatch, self._advance, self._finalize
        )

    def score_table(self, spectra):
        from ..ops.features import FeatureTable

        if not spectra:
            return FeatureTable.empty()
        if self.params.chimera:
            return self._score_chimera(spectra)
        return self._finalize(self._advance(self._dispatch(spectra)))

    def _dispatch(self, spectra):
        """Host prep and the step's stage 1 and merge for one batch."""
        h = self._host
        cols = BatchColumns(spectra)
        masses, intens = cols.masses, cols.intens
        rows = h._expand_rows(spectra, cols)
        n_rows = rows["si"].size
        nd = self._n_data
        R = -(-max(n_rows, nd) // nd) * nd
        # padding rows: the last spectrum, an empty window
        si = np.full(R, len(spectra) - 1, np.int32)
        si[:n_rows] = rows["si"]
        maxz = np.full(R, 2, np.int32)
        cfg = self.params.max_fragment_charge
        cap = np.minimum(rows["z"], cfg + 1) if cfg is not None else rows["z"]
        maxz[:n_rows] = np.maximum(cap, 2)
        i0 = np.zeros(R, np.int32)
        i1 = np.zeros(R, np.int32)
        i0[:n_rows] = rows["i0"]
        i1[:n_rows] = rows["i1"]

        max_win = int((rows["i1"] - rows["i0"]).max()) if n_rows else 1
        W = next_power_of_two(max(max_win, 8))
        search = self.search
        d = None
        if (W <= search.tables.P_local
                and os.environ.get("SAGE_TPU_SHARD_WINDOWED", "1") != "0"):
            d = search.windowed_dispatch(masses, intens, si, i0, i1, maxz, W)
        elif (self.db.fragment_mz_flat is not None
              and os.environ.get("SAGE_TPU_SHARD_OPEN", "1") != "0"):
            d = search.open_dispatch(masses, intens, si, i0, i1, maxz)
        if d is None:
            d = self._full_fallback(masses, intens, si, rows, n_rows, maxz)
        self.last_route = d["kind"]
        return {"spectra": spectra, "cols": cols, "masses": masses,
                "intens": intens, "rows": rows, "n_rows": n_rows,
                "n_spec": len(spectra), "d": d}

    def _full_fallback(self, masses, intens, si, rows, n_rows, maxz):
        """The whole-table step with f32 mass-range membership; the
        endpoints come from the index window, so membership is the
        single-device candidate range's."""
        mono = self.db.table.mono
        R = si.size
        lo = np.full(R, np.inf, np.float32)
        hi = np.full(R, -np.inf, np.float32)
        i0, i1 = rows["i0"], rows["i1"]
        lo[:n_rows] = np.where(i0 < len(mono),
                               mono[np.minimum(i0, len(mono) - 1)], np.inf)
        hi[:n_rows] = np.where(i1 > 0, mono[np.maximum(i1 - 1, 0)], -np.inf)
        # empty [i0, i1) windows stay empty
        empty = np.flatnonzero(i1 <= i0)
        lo[empty] = np.inf
        hi[empty] = -np.inf
        return self.search.full_dispatch(masses, intens, si, lo, hi, maxz)

    def _advance(self, e):
        """Stage 2 and the fetch of a dispatched batch."""
        out = self.search.step_result(e["d"])
        e["counts"], e["pep"] = out[:2]
        e["feats"] = list(out[2:9])
        e["row_mtot"], e["row_scored"] = out[9], out[10]
        return e

    def _finalize(self, e):
        prelim, packed = self._merge_prelim(e)
        d2 = {"out_dev": torch.from_numpy(packed),
              "nI": prelim["cand_spec"].size, "use_int": e["intens"]}
        return self._host._stage2_finalize(
            e["cols"], prelim, d2, self.params.report_psms,
        )

    def _merge_prelim(self, e):
        """Host merge of the fetched [R, K] grids: flatten (row, k), drop
        zero-matched, PreScore order with the single-device helper.
        Returns (prelim dict, packed [N, 7] f32 features)."""
        from ..ops.search import merge_prescore_candidates

        rows, n_rows, n_spec = e["rows"], e["n_rows"], e["n_spec"]
        K = self._host.K
        m = e["counts"][:n_rows].ravel()
        pp = e["pep"][:n_rows].ravel()
        ss = np.repeat(rows["si"], K)
        zz = np.repeat(rows["z"], K)
        ii = np.repeat(rows["iso"], K)
        sel = merge_prescore_candidates(m, pp, ss, zz, ii, K)
        spec_matched = np.bincount(
            rows["si"], weights=e["row_mtot"][:n_rows], minlength=n_spec
        ).astype(np.int64)
        spec_scored = np.bincount(
            rows["si"], weights=e["row_scored"][:n_rows], minlength=n_spec
        ).astype(np.int64)
        prelim = {
            "cand_matched": m[sel].astype(np.int32),
            "cand_pep": pp[sel].astype(np.int32),
            "cand_spec": ss[sel].astype(np.int32),
            "cand_charge": zz[sel].astype(np.int32),
            "cand_iso": ii[sel].astype(np.int32),
            "spec_matched": spec_matched,
            "spec_scored": spec_scored,
        }
        packed = np.stack([f[:n_rows].reshape(-1)[sel].astype(np.float32)
                           for f in e["feats"]], axis=1)
        return prelim, packed

    # -- chimeric search on the grid (scoring.rs:598-672) -----------------

    def _score_chimera(self, spectra):
        """The preliminary candidates once, from the ordinary step; each
        later round rescores them on the grid with the removed peaks
        masked (:meth:`ShardedSearch.rescore`). The round bookkeeping is
        the single-device ``chimera_rounds``."""
        from ..ops.search import chimera_rounds

        h = self._host
        e = self._advance(self._dispatch(spectra))
        prelim, packed0 = self._merge_prelim(e)
        masses, intens = e["masses"], e["intens"]

        def features_table(removed, tic):
            use_int = intens
            packed = packed0  # round 0: the step's own rescore
            if removed.any():
                use_int = np.where(removed, -1.0, intens).astype(np.float32)
                packed = self._rescore_candidates(prelim, masses, use_int)
            d2 = {"out_dev": torch.from_numpy(packed),
                  "nI": prelim["cand_spec"].size, "use_int": use_int}
            return h._stage2_finalize(e["cols"], prelim, d2, 1,
                                      tic_override=tic)

        return chimera_rounds(h, spectra, masses, intens, features_table)

    def _rescore_candidates(self, prelim, masses, use_int):
        """Grid rescore of prelim's candidates with the (masked) peak
        intensities: packed f32 [nI, 7]."""
        chg = prelim["cand_charge"]
        cfg = self.params.max_fragment_charge
        cap = np.minimum(chg, cfg + 1) if cfg is not None else chg
        maxz = np.minimum(np.maximum(cap, 2), self._host.Z + 1)
        return self.search.rescore(masses, use_int, prelim["cand_spec"],
                                   prelim["cand_pep"], maxz.astype(np.int32))
