"""The search engine's fused path in PyTorch: batched spectrum scoring on
an NVIDIA GPU (or, with ``device="cpu"``, on the CPU with every kernel's
plain version).

Counterpart of ``sage_tpu/ops/search.py``. Narrow windows take the
candidate-major stage 1: each query row's precursor window is a
contiguous slice of the mass-sorted ladder table, and matches are
counted with the rank-difference trick ``#(lo_q <= f) - #(hi_q < f)``
over the per-charge query-window bounds (the CUDA kernel in
``csrc/stage1_counts.cu``). Windows of ``SAGE_TPU_OPEN_THRESHOLD`` (8192)
candidates or more take the peak-major open search
(``ops/open_search.py``, whose entry rows the kernels of
``csrc/row_sort.cu`` and ``csrc/cluster_sort.cu`` sort). One
merge/rescore/select pass then keeps the top-K candidates per spectrum
by the PreScore order, rescores them with full ladders (the CUDA kernel
in ``csrc/rescore.cu``, ``ops/rescore.py``), and selects the reported
rows by an f32 hyperscore key that the host verifies with exact f64
arithmetic.

Where the fused path's preconditions do not hold (its bit-packed lanes,
``SAGE_TPU_FUSED=0``, an open batch split deeper than one level, the
per-spectrum sums past 2^24) the batch takes the two-dispatch path, as
in the JAX package: stage 1 (the same kernels), a host PreScore merge
(``merge_prescore_candidates``), then a per-item full rescore and the
host's exact selection.

Every f32 value keeps the reference's op order: eager ops (never a
fused multiply-add), divisions by device tensors (a CUDA division by a
host scalar is computed as a reciprocal multiply), and strictly
sequential sums. Integer fields that the JAX package packs as int32 stay
int32.

Narrow windows of 16384 candidates or more (with the open threshold
raised) and ppm fragments, or any batch under ``SAGE_TPU_NARROW_BANDED=1``,
take the peak-major banded stage 1 (``ops/narrow_banded.py``: a device
binary search over a (band, m/z)-sorted fragment index, then the open
search's count core). Chimeric search re-scores
each spectrum in rounds with the matched peaks of its best PSM removed
(``_score_chimera``, ``chimera_rounds``).
"""

from __future__ import annotations

import dataclasses
import logging
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..chem.mass import NEUTRON, PROTON, Tolerance
from ..index.builder import IndexedDatabase, next_power_of_two
from ..spectrum.processor import ProcessedSpectrum
from .features import (
    SAGE_HYPERSCORE,
    Feature,
    FeatureTable,
    Fragments,
    hyperscore_vec,
    log10_poisson_vec,
)
from .open_search import (
    V_ROW,
    OpenSearcher,
    _device_open_count,
    _quarter_octave,
    _range_stats,
    covered_bands,
    spectrum_window_union,
)
from .batch_prep import BatchColumns, batch_prep
from .narrow_banded import NarrowBanded
from .pallas_stage1 import stage1_counts
from .rescore import (
    _SERIES_NTERM,
    rescore_indexed,
    tol_bounds_static,
)
from ..utils import trace

log = logging.getLogger("sage_tpu_torch")

F32 = np.float32

# Ion-series seeds, computed in f32 exactly as ion_series.rs:37-53.
_C = F32(12.0)
_O = F32(15.994914)
_H = F32(1.007825)
_PRO = F32(1.0072764)
_N = F32(14.003074)
_NH3 = F32(F32(_N + F32(_H * F32(2.0))) + _PRO)

_SERIES_SEED = {
    "a": -F32(_C + _O),
    "b": F32(0.0),
    "c": _NH3,
    "x": F32(F32(F32(F32(_C + _O) - _NH3) + _N) + _H),
    "y": F32(0.0),
    "z": -_NH3,
}


def max_fragment_charge(cfg: Optional[int], precursor_charge: int) -> int:
    """Exclusive upper bound of the fragment-charge sweep (scoring.rs:234-247)."""
    cap = (cfg + 1) if cfg is not None else precursor_charge
    return max(min(precursor_charge, cap), 2)


def merge_prescore_candidates(m, pp, ss, zz, ii, K):
    """Host merge of flattened per-row candidates into the per-spectrum
    top-K with the PreScore ordering (matched desc, peptide desc, charge
    desc, isotope desc within each spectrum — scoring.rs:43-49 +
    trim_hits). Returns the selected indices into the flat arrays, in
    merged order."""
    keep = m > 0
    order = np.lexsort((-ii[keep], -zz[keep], -pp[keep], -m[keep], ss[keep]))
    sel = np.flatnonzero(keep)[order]
    ssel = ss[sel]
    if ssel.size:
        starts = np.r_[0, np.flatnonzero(np.diff(ssel)) + 1]
        group_start = np.repeat(starts, np.diff(np.r_[starts, ssel.size]))
        rank = np.arange(ssel.size) - group_start
        sel = sel[rank < K]
    return sel


def _pad_count(n: int) -> int:
    """Batch-axis padding: powers of two up to 2048, then multiples of
    2048."""
    n = max(n, 8)
    if n <= 2048:
        return next_power_of_two(n)
    return ((n + 2047) // 2048) * 2048


# Ladder-length classes for stage-1 row bucketing: a fixed value grid
# (not data-derived) so the set of segment shapes stays small and stable
# across batches.
_LC_GRID = (8, 12, 16, 24, 32, 48, 64, 96, 128, 192, 256)


def _lc_class(need: int, L: int) -> int:
    for g in _LC_GRID:
        if g >= need and g <= L:
            return g
    return L


_LNEED_BLK = 64


def _lens_blockmax(lens: np.ndarray) -> np.ndarray:
    """[ceil(P/64)] max peptide length per 64-wide block of the
    mass-sorted table (precomputed once per database)."""
    P = lens.shape[0]
    nb = -(-max(P, 1) // _LNEED_BLK)
    pad = np.zeros(nb * _LNEED_BLK, np.int64)
    pad[:P] = lens
    return pad.reshape(nb, _LNEED_BLK).max(axis=1)


def _window_lneed(lens: np.ndarray, i0: np.ndarray, i1: np.ndarray,
                  blkmax: Optional[np.ndarray] = None):
    """Per-row UPPER BOUND of max(len) - 1 over the window [i0, i1) of
    the mass-sorted peptide table (0 for empty windows): the max of the
    64-wide blocks covering the window, edge blocks included whole.
    Sound for ladder-length CLASS assignment — a class covering the
    bound always covers the true need."""
    n = i0.size
    if n == 0:
        return np.zeros(0, np.int64)
    if blkmax is None:
        blkmax = _lens_blockmax(lens)
    nbk = blkmax.shape[0]
    a = i0.astype(np.int64) // _LNEED_BLK
    b = (np.maximum(i1.astype(np.int64), i0 + 1) - 1) // _LNEED_BLK
    m = np.zeros(n, np.int64)
    for j in range(int((b - a).max(initial=0)) + 1):
        bj = np.minimum(a + j, nbk - 1)
        m = np.maximum(m, np.where(a + j <= b, blkmax[bj], 0))
    return np.where(i1 > i0, np.maximum(m - 1, 0), 0)


@dataclasses.dataclass
class SearchParams:
    """Scorer configuration (scoring.rs:210-232)."""

    precursor_tol: Tolerance
    fragment_tol: Tolerance
    min_matched_peaks: int = 4
    min_isotope_err: int = 0
    max_isotope_err: int = 0
    min_precursor_charge: int = 2
    max_precursor_charge: int = 4
    override_precursor_charge: bool = False
    max_fragment_charge: Optional[int] = None
    chimera: bool = False
    report_psms: int = 1
    wide_window: bool = False
    annotate_matches: bool = False
    score_type: str = SAGE_HYPERSCORE


def _tol_tuple(tol: Tolerance):
    return (tol.kind, float(tol.lo), float(tol.hi))


def ion_ladders(res, ntm, mono, series):
    """Sequential-f32 cumulative ion ladders for the configured series.

    res: [..., L] per-residue masses (monoisotopic + mod); ntm/mono: [...]
    N-term mod and full monoisotopic mass. Returns f32 [S, ..., L] neutral
    fragment masses; ion i is valid for i < len - 1 (ion_series.rs:63-86).
    One eager add per ladder step, strictly left to right, matching the
    reference's scalar f32 running sums bit for bit."""
    inits = []
    signs = []
    for kind in series:
        seed = float(_SERIES_SEED[kind])
        if _SERIES_NTERM[kind]:
            inits.append(ntm + seed)
            signs.append(1.0)
        else:
            inits.append((mono - ntm) + seed)
            signs.append(-1.0)
    carry = torch.stack(inits, dim=0)  # [S, ...]
    sign = torch.tensor(signs, dtype=torch.float32, device=res.device).reshape(
        (len(series),) + (1,) * (res.dim() - 1)
    )
    steps = []
    for l in range(res.shape[-1]):
        carry = carry + sign * res[..., l][None]
        steps.append(carry)
    return torch.stack(steps, dim=-1)


def series_valid_mask(lens, L, series, min_ion_index):
    """[S, ..., L] bool: is ion i of each series stored in the index
    (database.rs:281-291) — drops the first min_ion_index ions from the
    relevant terminus plus ions beyond len - 1."""
    ion_idx = torch.arange(L, dtype=torch.int32, device=lens.device)
    n_ions = torch.clamp(lens - 1, min=0)[..., None]  # [..., 1]
    masks = []
    for kind in series:
        if _SERIES_NTERM[kind]:
            m = (ion_idx + 1 > min_ion_index) & (ion_idx < n_ions)
        else:
            m = ((n_ions - ion_idx) > min_ion_index) & (ion_idx < n_ions)
        masks.append(m)
    return torch.stack(masks, dim=0)


def count_fragment_matches(f, peaks, frag_tol, maxz, Z):
    """Per-candidate matched-peak counts via the rank-difference trick.

    f: [R, S, W, L] neutral fragment ladders with -inf in invalid slots
    (-inf falls in no window: ppm/pct bounds of -inf are NaN/-inf, da
    bounds -inf); peaks: [R, Pk] neutral peak masses padded with +inf;
    frag_tol: (kind, lo, hi); maxz: [R] i32 exclusive fragment-charge
    bound. Counts every in-window (peak x charge x fragment) pair, exactly
    the reference's preliminary matched count (scoring.rs:335-382).
    Returns i32 [R, W]."""
    kind, tlo, thi = frag_tol
    acc = torch.zeros((f.shape[0], f.shape[2]), dtype=torch.int32,
                      device=f.device)
    inf = torch.tensor(np.inf, dtype=torch.float32, device=f.device)
    fx = f[..., None]  # [R, S, W, L, 1]
    for zi in range(Z):
        q = peaks * float(zi + 1)
        lo_q, hi_q = tol_bounds_static(kind, tlo, thi, q)
        # Masked charge planes must contribute 0 to both the prefix count
        # (lo <= f) and the strict count (hi < f): +inf fails both
        # comparisons for any finite fragment.
        z_ok = ((zi + 1) < maxz)[:, None]
        lo_q = torch.where(z_ok, lo_q, inf)[:, None, None, None, :]
        hi_q = torch.where(z_ok, hi_q, inf)[:, None, None, None, :]
        acc += (fx >= lo_q).sum(dim=(1, 3, 4), dtype=torch.int32)
        acc -= (fx > hi_q).sum(dim=(1, 3, 4), dtype=torch.int32)
    return acc


def pipeline_stream(batches, admit, advance, finish):
    """Generic pipelined batch loop.

    Three phases per batch: ``admit`` (host prep + async device
    dispatch), ``advance`` (the blocking device fetch and the host
    finalize), ``finish`` (-> FeatureTable). PyTorch's CUDA launches are
    asynchronous, so keeping up to two batches in flight overlaps batch
    i's fetch/host work with the device's execution of batch i+1. Yields
    one FeatureTable per input batch, in order; empty input batches
    yield empty tables.

    On hosts with >= 4 cores a worker thread runs ``advance`` while the
    feeder admits and the consumer finishes (the fetch releases the
    GIL); on smaller hosts a sliding dispatch window of depth 2 runs on
    one thread. An admitted batch's time between its stages, queued for
    the other thread or behind other batches, is a ``search.wait`` span
    of its ``bid``."""
    import os

    from .features import FeatureTable

    def queued(e):
        e["_t_wait"] = trace.clock()
        return e

    def taken(e):
        if "_t_wait" in e:
            trace.interval("search.wait", e.pop("_t_wait"), e.get("bid"))
        return e

    if (os.cpu_count() or 1) >= 4:
        import queue as _q
        from concurrent.futures import ThreadPoolExecutor

        q1: "_q.Queue" = _q.Queue(maxsize=2)
        # q2 unbounded so the worker can never block on put (in-flight
        # work is bounded by q1's maxsize); a blocked worker would
        # deadlock executor shutdown if the consumer exits early.
        q2: "_q.Queue" = _q.Queue()
        _END = object()

        def worker_advance():
            while True:
                e = q1.get()
                if e is _END:
                    q2.put(_END)
                    return
                try:
                    q2.put(e if e.get("empty") else queued(advance(taken(e))))
                except BaseException as exc:  # propagate to consumer
                    q2.put(exc)
                    q2.put(_END)  # so the consumer's drain terminates
                    return

        with ThreadPoolExecutor(max_workers=1) as ex:
            ex.submit(worker_advance)
            it = iter(batches)
            done_feeding = False
            try:
                while True:
                    # feed admits until q1 is full or input exhausted
                    while not done_feeding and not q1.full():
                        try:
                            batch = next(it)
                        except StopIteration:
                            done_feeding = True
                            q1.put(_END)
                            break
                        q1.put(
                            {"empty": True} if not batch
                            else queued(admit(batch))
                        )
                    e = q2.get()
                    if e is _END:
                        break
                    if isinstance(e, BaseException):
                        raise e
                    yield (FeatureTable.empty() if e.get("empty")
                           else finish(taken(e)))
            finally:
                # On ANY early exit (consumer exception, GeneratorExit
                # from an abandoned generator) the worker must be
                # released or executor shutdown hangs. The worker posts
                # _END after normal completion AND after posting an
                # exception, so draining q2 always terminates; q1 may
                # be full with a dead worker, hence put_nowait retries
                # interleaved with q2 drains.
                if not done_feeding:
                    done_feeding = True
                    ended = False
                    while True:
                        try:
                            q1.put_nowait(_END)
                            break
                        except _q.Full:
                            try:
                                if q2.get(timeout=0.2) is _END:
                                    ended = True
                                    break
                            except _q.Empty:
                                continue
                    while not ended:
                        if q2.get() is _END:
                            ended = True
        return

    # single-threaded: sliding window of depth A. Empty batches flow
    # through `pend` as markers so results stay in 1:1 input order.
    from collections import deque

    def finish_any(e):
        return FeatureTable.empty() if e.get("empty") else finish(taken(e))

    def advance_once(e):
        if not e.get("empty") and not e.get("_advanced"):
            e["_advanced"] = True
            queued(advance(taken(e)))

    pend = deque()
    A = 2
    for batch in batches:
        pend.append({"empty": True} if not batch else queued(admit(batch)))
        if len(pend) >= A + 1:
            advance_once(pend[-(A + 1)])  # oldest un-advanced entry
        if len(pend) >= A + 2:
            yield finish_any(pend.popleft())
    for e in pend:
        advance_once(e)
    while pend:
        yield finish_any(pend.popleft())


def _to_dev(a: np.ndarray, device) -> torch.Tensor:
    """Copy a host array to ``device``: a ``search.upload`` span, its
    bytes counted in ``search.upload_bytes``."""
    a = np.ascontiguousarray(a)
    with trace.span("search.upload"):
        trace.count("search.upload_bytes", a.nbytes)
        return torch.from_numpy(a).to(device)


class _DeviceTables:
    """Device-resident ladder tables, padded to a multiple of 2048 rows so
    any precursor-window slice of width W <= P_pad stays in bounds. With
    ``rows = (base, P_pad)`` the tables hold the peptide rows
    [base, base + P_pad) alone, padded to exactly P_pad rows: one model
    shard's part of the table (``parallel/sharding.py``).

    * ``lad_index`` [P_pad, S, L] f32: ladders with the index's
      min_ion_index filter applied (database.rs:281-291); filtered and
      invalid slots hold -inf so they never fall inside a query window.
      Stage 1 reads it.
    * ``lad_full``  [P_pad, S, L] f32: complete ladders (only the
      ion < len-1 validity applied) for the full rescore, which ignores
      min_ion_index (scoring.rs:675-767).
    * ``mono`` [P_pad] f32: the ascending peptide masses, +inf in the
      pads, that ``batch_prep`` searches the precursor windows in.

    A candidate's [S, L] row is contiguous in both."""

    def __init__(self, db: IndexedDatabase, series, min_ion_index, device,
                 rows=None):
        t = db.table
        if rows is None:
            sl = slice(0, len(t))
            self.P_pad = max(((len(t) + 2047) // 2048) * 2048, 128)
        else:
            base, self.P_pad = rows
            sl = slice(min(base, len(t)), min(base + self.P_pad, len(t)))
        P = sl.stop - sl.start
        self.P_real = P
        L = t.max_len
        self.L = L
        pad = self.P_pad - P
        resmass = _to_dev(
            np.pad(t.resmass[sl], ((0, pad), (0, 0))).astype(np.float32),
            device,
        )
        nterm = _to_dev(np.pad(t.nterm[sl], (0, pad)).astype(np.float32),
                        device)
        self.mono = mono = _to_dev(
            np.pad(t.mono[sl], (0, pad),
                   constant_values=np.inf).astype(np.float32),
            device,
        )
        lens = _to_dev(np.pad(t.lens[sl], (0, pad)).astype(np.int32), device)
        neg_inf = torch.tensor(-np.inf, dtype=torch.float32, device=device)
        lad = ion_ladders(resmass, nterm, mono, series)  # [S, P_pad, L]
        idx_valid = series_valid_mask(lens, L, series, min_ion_index)
        ion_idx = torch.arange(L, dtype=torch.int32, device=device)
        full_valid = ion_idx[None, :] < torch.clamp(lens - 1, min=0)[:, None]
        # [S, P, L] -> [P, S, L] so per-candidate rows are contiguous
        self.lad_index = (
            torch.where(idx_valid, lad, neg_inf).permute(1, 0, 2).contiguous()
        )
        self.lad_full = (
            torch.where(full_valid[None], lad, neg_inf)
            .permute(1, 0, 2).contiguous()
        )


def _topk_layout(counts_packed, p0, W: int, K: int):
    """Per-row top-K of a counts-only stage-1 output [R, W+2] into the
    [R, 2K+2] layout (vals, pep, mtot, scored). Order: count descending,
    then the higher peptide index first (PreScore Ord, scoring.rs:43-49)
    — a stable descending sort of the reversed counts, the tie rule of
    ``lax.top_k`` on the reversed axis."""
    rev = counts_packed[:, :W].flip(-1)
    vals, ridx = torch.sort(rev, dim=1, descending=True, stable=True)
    pep = p0[:, None] + (W - 1 - ridx[:, :K]).to(torch.int32)
    return torch.cat(
        [vals[:, :K], pep.to(torch.int32), counts_packed[:, W : W + 2]], dim=1
    )


class Scorer:
    """Score ProcessedSpectrum batches against an IndexedDatabase.

    ``device``: where the tables live and the search runs. Defaults to
    ``"cuda"``; with no CUDA device the caller must pass ``"cpu"``
    explicitly (the plain versions of every kernel then run).
    ``build_device_tables=False`` builds the host machinery alone (row
    expansion, peak padding, the PreScore merge, feature assembly, the
    chimera rounds) and no tables: the form that
    ``parallel.sharding.ShardedScorer`` embeds, whose device work runs on
    its mesh."""

    # The device's hs32 and the host's f64 hyperscore consume the SAME
    # fetched f32 (mb, my, sb, sy), so their divergence is pure rounding:
    # a 3-4 term sum of log/table values each within ~2 ulps. EPS = 2e-3
    # is a >10x margin; a spectrum only falls back when distinct
    # candidates straddle the selection boundary within EPS — exact ties
    # at the boundary included.
    SELECT_EPS = 2e-3

    def __init__(self, db: IndexedDatabase, params: SearchParams,
                 device=None, build_device_tables: bool = True):
        if device is None and build_device_tables:
            if not torch.cuda.is_available():
                raise RuntimeError(
                    "Scorer: no CUDA device is available; pass "
                    "device='cpu' to run the plain versions on the CPU"
                )
            device = "cuda"
        self.device = torch.device(device or "cpu")
        self.db = db
        self.params = params
        self.series = tuple(db.ion_kinds)
        self.n_series = len(self.series)
        self.min_ion_index = db.min_ion_index
        self.tables = (
            _DeviceTables(db, self.series, self.min_ion_index, self.device)
            if build_device_tables else None
        )
        # Global fragment-charge axis: 1..Zmax where Zmax is the largest
        # exclusive bound any precursor charge can produce.
        zmax = max(
            max_fragment_charge(params.max_fragment_charge, z)
            for z in range(1, params.max_precursor_charge + 1)
        )
        self.Z = max(zmax - 1, 1)
        # trim_hits K-select bound (scoring.rs:311-329): top-50 by matched
        # count, widened to 2x report_psms when more PSMs are requested
        self.K = max(50, params.report_psms * 2)
        self._cache: Dict[tuple, object] = {}
        self._plan_sticky: Dict[Tuple[int, int], tuple] = {}
        self._psm_counter = 1
        self._open: Optional[OpenSearcher] = None
        self._nb: Optional[NarrowBanded] = None
        self._stream = None
        self.fused_reruns = 0
        self.last_plan: Optional[dict] = None

    # ------------------------------------------------------------------
    # Device programs
    # ------------------------------------------------------------------

    def _stage1(self, W, Pk, R, Z, Lc=None):
        """Stage 1 for one (W, Pk, R, Z, Lc) segment: returns
        ``(run, counts_only)`` where ``run(peaks_dev, ints)`` maps the
        packed peaks [2, B, Pk] and the rows i32 [5, R] (spectrum, p0,
        i0, i1, maxz) to the counts-only [R, W+2] layout when W <= K,
        else the per-row top-K [R, 2K+2] layout (vals, pep, mtot,
        scored). Every width runs the stage-1 kernel on a CUDA device."""
        tables = self.tables
        Lc = tables.L if Lc is None else min(Lc, tables.L)
        K = self.K
        tol = _tol_tuple(self.params.fragment_tol)
        counts_only = W <= K

        def run(peaks_dev, ints):
            counts = stage1_counts(
                tables.lad_index, peaks_dev[0], ints, W=W, Lc=Lc, Z=Z, tol=tol
            )
            if counts_only:
                return counts
            return _topk_layout(counts, ints[1], W, K)

        return run, counts_only

    def _open_path(self, W: int) -> bool:
        """Would the JAX package take the peak-major open-search path?"""
        import os

        if self.db.fragment_mz_flat is None:
            return False
        thresh = int(os.environ.get("SAGE_TPU_OPEN_THRESHOLD", "8192"))
        return W >= thresh

    def _open_searcher(self) -> OpenSearcher:
        if self._open is None:
            self._open = OpenSearcher(
                self.db, self.params.fragment_tol, self.Z, K=self.K,
                precursor_tol=self.params.precursor_tol, device=self.device,
            )
        return self._open

    def _narrow_banded_maybe(self, W: int) -> Optional[NarrowBanded]:
        """The peak-major banded stage 1 (ops/narrow_banded.py).
        ``SAGE_TPU_NARROW_BANDED=0`` turns it off and ``=1`` forces it.
        Otherwise it is taken where it beat the candidate-major stage 1 on
        the H100 (``chip_smoke.py`` phase 19, PERF.md): windows of
        W >= 16384 candidates with a ppm fragment tolerance no wider than
        +-10 ppm, on an index of 2^19 fragments or more. Such windows stay
        narrow only when ``SAGE_TPU_OPEN_THRESHOLD`` is raised above its
        8192. At W <= 8192, and with +-0.5 Da fragments at every W, it was
        no faster. The JAX package's gate (W >= 4096 on 2^19 fragments)
        is its TPU tuning."""
        import os

        env = os.environ.get("SAGE_TPU_NARROW_BANDED", "")
        if env == "0" or self.db.fragment_mz_flat is None:
            return None
        ft = self.params.fragment_tol
        if env != "1" and not (
            W >= 16384 and ft.kind == "ppm" and ft.hi - ft.lo <= 20.0
            and self.db.num_fragments >= (1 << 19)
        ):
            return None
        if self._nb is None:
            self._nb = NarrowBanded(self.db, self.K, device=self.device)
        return self._nb

    # ------------------------------------------------------------------
    # Host orchestration
    # ------------------------------------------------------------------

    def _expand_rows(self, spectra: Sequence[ProcessedSpectrum],
                     cols: Optional[BatchColumns] = None):
        """initial_hits charge/isotope expansion (scoring.rs:384-462): one
        query row per (spectrum, precursor charge, isotope error).

        The host's whole row prep, and the reference that ``_prep``'s
        columns and ``batch_prep`` are held to: the window bounds
        (``_window_rows``) and the peptide-table binary searches
        (``_search_rows``) run as whole-array numpy f32 ops (elementwise
        identical to the reference's scalar f32 math). ``cols``: the
        batch's ``BatchColumns``, where the caller has them. Returns a
        dict of row arrays {si, z, iso, i0, i1}."""
        if cols is None:
            cols = BatchColumns(spectra)
        if self.params.wide_window:
            rows = self._wide_window_rows(spectra, cols.prec_mz)
        else:
            rows = self._window_rows(cols.prec_mz, cols.prec_z)
        return self._search_rows(rows)

    def _search_rows(self, rows):
        """The rows' peptide-table ranges on the host: their bounds
        ``lo`` and ``hi`` replaced by i0 (the masses below lo) and i1
        (the masses at or below hi), by ``np.searchsorted``."""
        mono = self.db.table.mono
        rows["i0"] = np.searchsorted(mono, rows.pop("lo"),
                                     side="left").astype(np.int32)
        rows["i1"] = np.searchsorted(mono, rows.pop("hi"),
                                     side="right").astype(np.int32)
        return rows

    def _row_axes(self):
        """The isotope errors and the swept precursor charges."""
        p = self.params
        if p.min_isotope_err != p.max_isotope_err:
            iso_list = np.arange(
                p.min_isotope_err, p.max_isotope_err + 1, dtype=np.int32
            )
        else:
            iso_list = np.zeros(1, dtype=np.int32)
        z_sweep = np.arange(p.min_precursor_charge,
                            p.max_precursor_charge + 1, dtype=np.int32)
        return iso_list, z_sweep

    def _window_rows(self, prec_mz, prec_z):
        """The query rows and their precursor-window bounds, from each
        spectrum's f32 precursor m/z and charge (0: none): rows by
        spectrum, then charge (the file's, or the swept range), then
        isotope error. Returns {si, z, iso, lo, hi}."""
        p = self.params
        mz = prec_mz - F32(PROTON)
        iso_list, z_sweep = self._row_axes()
        n_iso, nz = iso_list.size, z_sweep.size
        ann = (prec_z > 0) & (not p.override_precursor_charge)
        ann_idx = np.flatnonzero(ann)
        sw_idx = np.flatnonzero(~ann)
        si_a = np.repeat(ann_idx.astype(np.int32), n_iso)
        z_a = np.repeat(prec_z[ann_idx], n_iso)
        iso_a = np.tile(iso_list, ann_idx.size)
        si_s = np.repeat(sw_idx.astype(np.int32), nz * n_iso)
        z_s = np.tile(np.repeat(z_sweep, n_iso), sw_idx.size)
        iso_s = np.tile(iso_list, nz * sw_idx.size)
        si_rows = np.concatenate([si_a, si_s])
        z_rows = np.concatenate([z_a, z_s])
        iso_rows = np.concatenate([iso_a, iso_s])
        order = np.argsort(si_rows, kind="stable")
        si_rows, z_rows, iso_rows = (
            si_rows[order], z_rows[order], iso_rows[order],
        )
        pm = (mz[si_rows] * z_rows.astype(np.float32)).astype(np.float32)
        qm = pm - (iso_rows.astype(np.float32) * F32(NEUTRON))
        lo, hi = p.precursor_tol.bounds(qm)
        return {
            "si": si_rows.astype(np.int32),
            "z": z_rows.astype(np.int32),
            "iso": iso_rows.astype(np.int32),
            "lo": lo,
            "hi": hi,
        }

    def _wide_window_rows(self, spectra, prec_mz):
        """``_window_rows`` for wide-window search: per-spectrum isolation
        windows differ and the scaled-tolerance bounds must keep the
        reference's scalar f32 op order, so this (rarer) mode stays a
        scalar loop."""
        mz = prec_mz - F32(PROTON)
        iso_list, z_sweep = self._row_axes()
        si_l, z_l, iso_l, lo_l, hi_l = [], [], [], [], []
        for si, spec in enumerate(spectra):
            base = spec.precursors[0].isolation_window or Tolerance(
                "da", -2.4, 2.4
            )
            for z in z_sweep:
                tol = base * float(z)
                pm = F32(mz[si] * F32(z))
                for iso in iso_list:
                    qm = F32(pm - F32(F32(iso) * NEUTRON))
                    lo, hi = tol.bounds(qm)
                    si_l.append(si)
                    z_l.append(int(z))
                    iso_l.append(int(iso))
                    lo_l.append(lo)
                    hi_l.append(hi)
        return {
            "si": np.asarray(si_l, np.int32),
            "z": np.asarray(z_l, np.int32),
            "iso": np.asarray(iso_l, np.int32),
            "lo": np.asarray(lo_l, np.float32),
            "hi": np.asarray(hi_l, np.float32),
        }

    def _peaks_device(self, masses, intens):
        """Device-resident packed peaks [2, B, Pk] (masses, intensities),
        one upload per batch."""
        return _to_dev(np.stack([masses, intens]), self.device)

    def _pad_peaks(self, spectra: Sequence[ProcessedSpectrum]):
        """The host's padded peaks (masses, intensities, Pk), from the
        batch's columns: the prep of the paths that keep the host's
        (chimera, wide window, the grid) and the reference for
        ``batch_prep``'s block."""
        cols = BatchColumns(spectra)
        return cols.masses, cols.intens, cols.Pk

    def _prep(self, spectra: Sequence[ProcessedSpectrum]):
        """The ``search.prep`` of ``score_table`` and ``score_stream``:
        the batch read once into columns (``BatchColumns``), the query
        rows' window bounds on the host (``_window_rows``), then one
        ``batch_prep`` that pads the peaks into the device block
        [2, B, Pk] and searches the rows' bounds in the device's peptide
        masses. Wide-window search keeps the host's prep. Returns
        (cols, peaks_dev, rows), ``rows`` as ``_expand_rows`` gives
        them; the host pads ``cols.masses`` and ``cols.intens`` only
        where a later step reads them."""
        cols = BatchColumns(spectra)
        if self.params.wide_window:
            rows = self._search_rows(
                self._wide_window_rows(spectra, cols.prec_mz))
            return cols, self._peaks_device(cols.masses, cols.intens), rows
        rows = self._window_rows(cols.prec_mz, cols.prec_z)
        peaks_dev, i01 = self._batch_prep(cols, rows.pop("lo"),
                                          rows.pop("hi"))
        rows["i0"], rows["i1"] = i01[0], i01[1]
        return cols, peaks_dev, rows

    def _batch_prep(self, cols: BatchColumns, lo, hi):
        """``batch_prep`` for one batch: its flat peaks, bounds and
        offsets staged in one f32 host buffer (pinned on a card, from
        torch's caching host allocator, so buffers are reused once their
        copies are done) and copied in once. On a card the copy, the
        kernel and the download of i0 / i1 run on a stream of their own,
        so they do not queue behind the previous batch's work; the
        current stream waits for them before anything reads the block.
        The ``search.upload`` span covers the copy, a ``search.fetch``
        span the host's wait for i0 / i1. Returns (peaks_dev
        [2, B, Pk], i01 i32 [2, R] on the host)."""
        S, N, R = len(cols), cols.n_peaks, lo.size
        card = self.device.type == "cuda"
        host = torch.empty(2 * N + 2 * R + S + 1, dtype=torch.float32,
                           pin_memory=card)
        buf = host.numpy()
        cols.flatten_into(buf[:N], buf[N : 2 * N])
        buf[2 * N : 2 * N + R] = lo
        buf[2 * N + R : 2 * N + 2 * R] = hi
        buf[2 * N + 2 * R :].view(np.int32)[:] = cols.offs
        tabs = self.tables

        def launch(t):
            return batch_prep(
                t[:N], t[N : 2 * N], t[2 * N + 2 * R :].view(torch.int32),
                t[2 * N : 2 * N + R], t[2 * N + R : 2 * N + 2 * R],
                tabs.mono, P=tabs.P_real, Pk=cols.Pk,
            )

        with trace.span("search.upload"):
            trace.count("search.upload_bytes", host.numel() * 4)
            if card:
                stream = self._prep_stream()
                with torch.cuda.stream(stream):
                    staged = host.to(self.device, non_blocking=True)
        if not card:
            peaks, i01 = launch(host)
            return peaks, i01.numpy()
        with torch.cuda.stream(stream):
            peaks, i01 = launch(staged)
            back = torch.empty((2, R), dtype=torch.int32, pin_memory=True)
            back.copy_(i01, non_blocking=True)
            done = torch.cuda.Event()
            done.record(stream)
        current = torch.cuda.current_stream(self.device)
        peaks.record_stream(current)
        current.wait_event(done)
        with trace.span("search.fetch"):
            done.synchronize()
        return peaks, back.numpy()

    def _prep_stream(self):
        """The card's stream for ``_batch_prep``, at the highest
        priority, so its kernel's blocks go before queued stage-1
        blocks."""
        if self._stream is None:
            self._stream = torch.cuda.Stream(self.device, priority=-1)
        return self._stream

    def score(self, spectra: Sequence[ProcessedSpectrum]) -> List[Feature]:
        """Score a batch of MS2 spectra; returns Feature objects (tests /
        small batches). Production callers use :meth:`score_table`."""
        return self.score_table(spectra).to_features()

    def score_table(self, spectra: Sequence[ProcessedSpectrum]) -> FeatureTable:
        """Score a batch of MS2 spectra into a columnar FeatureTable
        (report_psms per spectrum), reference score_standard semantics."""
        if not spectra:
            return FeatureTable.empty()
        if self.params.chimera:
            return self._score_chimera(spectra)
        bid = trace.new_batch()
        with trace.span("search.prep", bid):
            cols, peaks_dev, rows = self._prep(spectra)
        with trace.span("search.dispatch", bid):
            fd = self._fused_dispatch(spectra, cols, peaks_dev, rows=rows)
        if fd is None:
            return self._two_dispatch(spectra, cols, peaks_dev, rows, bid)
        with trace.span("search.finalize", bid):
            t = self._fused_finalize(fd, cols)
        if t is not None:
            return t
        self._note_rerun()
        with trace.span("search.rerun", bid):
            return self._two_dispatch(spectra, cols, peaks_dev, rows)

    def _two_dispatch(self, spectra, cols, peaks_dev, rows, batch=None):
        """Stage 1 and the host merge, then the per-item rescore and the
        host selection: the path of every batch the fused path declines
        (``cols``: the batch's ``BatchColumns``). ``batch``: the batch id
        of its spans (else the enclosing span's)."""
        with trace.span("search.dispatch", batch):
            d1 = self._prelim_dispatch(spectra, masses=cols.masses,
                                       peaks_dev=peaks_dev, rows=rows)
        with trace.span("search.finalize", batch):
            prelim = self._prelim_finalize(d1)
        return self._features_table(cols, prelim, peaks_dev=peaks_dev,
                                    batch=batch)

    def _note_rerun(self):
        """Count and log a fused batch that _fused_finalize declined (a
        banded batch's entry capacity or a device-planned open batch's
        sticky shapes overflowed and grew, or a sum reached 2^24); the
        caller scores it again through the two-dispatch path, as the JAX
        package does."""
        self.fused_reruns += 1
        log.warning(
            "fused capacity overflow (banded entries or open sticky "
            "shapes); re-running the batch via the two-dispatch path"
        )

    def score_stream(self, batches):
        """Pipelined scoring over an iterable of spectrum batches: up to
        two batches in flight, so the device runs batch i+1 while the
        host fetches and finalizes batch i. Yields one FeatureTable per
        input batch, in order. Chimeric search scores one batch at a
        time: each of its rounds depends on the last one's PSMs."""
        if self.params.chimera:
            for batch in batches:
                yield self.score_table(batch)
            return

        def admit(batch):
            bid = trace.new_batch()
            with trace.span("search.prep", bid):
                cols, peaks_dev, rows = self._prep(batch)
            e = {
                "bid": bid, "batch": batch, "cols": cols,
                "peaks_dev": peaks_dev, "rows": rows,
            }
            with trace.span("search.dispatch", bid):
                e["fd"] = self._fused_dispatch(batch, cols, peaks_dev,
                                               rows=rows)
                if e["fd"] is None:
                    e["d1"] = self._prelim_dispatch(
                        batch, masses=cols.masses, peaks_dev=peaks_dev,
                        rows=rows,
                    )
            return e

        def advance(e):
            # the stage-1 fetch, host merge and stage-2 launch; or, on the
            # fused path, the packed fetch and the whole host finalize
            bid = e["bid"]
            if e["fd"] is None:
                with trace.span("search.finalize", bid):
                    e["prelim"] = self._prelim_finalize(e["d1"])
                with trace.span("search.dispatch", bid):
                    e["d2"] = self._stage2_dispatch(
                        e["prelim"], e["cols"].intens, e["peaks_dev"]
                    )
            else:
                with trace.span("search.fetch", bid):
                    packed_np = e["fd"]["fused"].cpu().numpy()
                with trace.span("search.finalize", bid):
                    e["table"] = self._fused_finalize(
                        e["fd"], e["cols"], packed=packed_np,
                    )
            return e

        def finish(e):
            cols = e["cols"]
            if e["fd"] is None:
                with trace.span("search.finalize", e["bid"]):
                    return self._stage2_finalize(
                        cols, e["prelim"], e["d2"], self.params.report_psms,
                    )
            if e["table"] is not None:
                return e["table"]
            self._note_rerun()
            with trace.span("search.rerun", e["bid"]):
                return self._two_dispatch(e["batch"], cols, e["peaks_dev"],
                                          e["rows"])

        yield from pipeline_stream(batches, admit, advance, finish)

    # ------------------------------------------------------------------
    # Fused path: stage 1 + merge + rescore + select, one fetch
    # ------------------------------------------------------------------

    def _build_fused(self, plan, Pk, S_pad, G_eff, Zb, Ksel):
        """The merge/rescore/select pass over the segmented stage-1
        outputs (each (window-width Wb, ladder-length Lcb, padded-rows Rb,
        charge planes Zc) segment ran at its own shape): a GATHER into the
        per-spectrum [S_pad, G_eff*K] merge grid by a host-computed slot
        permutation, the PreScore merge (counts/peptide/charge/isotope
        descending — scoring.rs:43-49 + trim_hits), the full rescore on
        the [S_pad, K] merge grid, and a per-spectrum SELECTION of the
        top-Ksel candidates by an f32 hyperscore order key (the
        reference's score_standard sort, scoring.rs:495). Only the
        selected rows plus per-spectrum statistics are fetched; the
        untruncated candidate arrays stay on the device for the host
        guard's fallback (see _fused_finalize)."""
        from .features import lnfact_vec

        K = self.K
        K0 = K  # the merge keeps at most K candidates per spectrum
        Ksel = min(Ksel, K0)
        tables = self.tables
        series = self.series
        frag_tol = _tol_tuple(self.params.fragment_tol)
        L = tables.L
        cfg = self.params.max_fragment_charge
        Zcap = self.Z
        min_matched = self.params.min_matched_peaks
        openms = self.params.score_type != SAGE_HYPERSCORE
        dev = self.device
        # f32 lnfact table for the device-side hyperscore ORDER key (the
        # exact f64 value is recomputed on host for the fetched rows)
        lnf = _to_dev(
            lnfact_vec(np.arange(self.n_series * L * max(Zcap, 1) + 2))
            .astype(np.float32), dev,
        )
        seg_meta = []
        off = 0
        for entry in plan:
            if entry[0] == "banded":
                # an open-search pseudo-segment: its count core already
                # produced the [R, 2K+2] top-K layout
                seg_meta.append((False, None, entry[1], off))
                off += entry[1]
            else:
                Wb, Rb = entry[0], entry[2]
                seg_meta.append((Wb <= K, Wb, Rb, off))
                off += Rb
        i32 = torch.int32

        def run_inner(peaks_dev, ints, perm, seg_outs, tail_extra):
            # ints: [8, R_tot] i32 (spec, p0, i0, i1, maxz, z, iso, slot)
            # with spec == S_pad marking padding rows; perm: [S_pad *
            # G_eff] spectrum-major slot -> global stage-1 row (empty
            # slots point at the all-zero sentinel row R_tot); seg_outs:
            # the stage-1 outputs, one per plan segment; tail_extra: None
            # or i32 device scalars (an open batch's per-class overflow
            # statistics) that ride the tail row.
            canon = []
            for (co_b, Wb, Rb, o), packed in zip(seg_meta, seg_outs):
                if co_b:  # [Rb, Wb+2] raw window counts -> top-K layout
                    vals_b = packed[:, :Wb]
                    pep_b = ints[1, o : o + Rb, None] + torch.arange(
                        Wb, dtype=i32, device=dev
                    )[None, :]
                    if Wb < K:
                        vals_b = torch.nn.functional.pad(vals_b, (0, K - Wb))
                        pep_b = torch.nn.functional.pad(
                            pep_b, (0, K - Wb), value=-1
                        )
                    canon.append(torch.cat(
                        [vals_b, pep_b, packed[:, Wb : Wb + 2]], dim=1
                    ))
                else:  # [Rb, 2K+2] per-row top-K (vals, pep, mtot, scored)
                    canon.append(packed[:, : 2 * K + 2])
            sent = torch.zeros((1, 2 * K + 2), dtype=i32, device=dev)
            sent[0, K : 2 * K] = -1
            allp = torch.cat(canon + [sent], dim=0)
            g = allp[perm].reshape(S_pad, G_eff, 2 * K + 2)  # row gather
            mtot_s = g[:, :, 2 * K].sum(dim=1, dtype=i32).to(torch.float32)
            scored_s = g[:, :, 2 * K + 1].sum(dim=1, dtype=i32).to(
                torch.float32
            )
            # per-slot charge/isotope straight from the row table
            zero1 = torch.zeros(1, dtype=i32, device=dev)
            z_g = torch.cat([ints[5], zero1])[perm].reshape(S_pad, G_eff)
            iso_g = torch.cat([ints[6], zero1])[perm].reshape(S_pad, G_eff)
            GK = G_eff * K
            counts2 = g[:, :, :K].reshape(S_pad, GK)
            pep2 = g[:, :, K : 2 * K].reshape(S_pad, GK)
            z2 = z_g[:, :, None].expand(S_pad, G_eff, K).reshape(S_pad, GK)
            iso2 = iso_g[:, :, None].expand(S_pad, G_eff, K).reshape(S_pad, GK)

            # The 4-key PreScore sort (counts, pep, z, iso, all descending)
            # as ONE int64 key sorted descending. Field widths:
            #   iso+16  bits 0-4    iso in [-16, 15]    (checked in dispatch)
            #   z       bits 5-9    z < 32              (checked in dispatch)
            #   pep+1   bits 10-34  pep in [-1, 2^24)   (len(db) < 2^24)
            #   counts  bits 35-62  counts >= 0, far below 2^28
            key = (
                (counts2.to(torch.int64) << 35)
                | ((pep2.to(torch.int64) + 1) << 10)
                | (z2.to(torch.int64) << 5)
                | (iso2.to(torch.int64) + 16)
            )
            key = torch.sort(key, dim=1, descending=True).values[:, :K0]
            m_s = (key >> 35).to(i32)
            pep_s = ((key >> 10) & ((1 << 25) - 1)).to(i32) - 1
            z_s = ((key >> 5) & 31).to(i32)
            iso_s = (key & 31).to(i32) - 16

            mask = m_s > 0  # sorted desc: a prefix per spectrum
            cnt_s = mask.sum(dim=1, dtype=i32)
            total = cnt_s.sum(dtype=i32)
            # fallback slice bounds: spectrum s's items live at the fixed
            # stride rows [s*K0, s*K0 + cnt_s) of the flattened grid
            offs = torch.arange(S_pad, dtype=i32, device=dev) * K0

            # stage 2 directly on the [S_pad, K0] merge grid, the peaks
            # broadcast per spectrum
            cap = torch.clamp(z_s, max=cfg + 1) if cfg is not None else z_s
            c_maxz = torch.clamp(torch.clamp(cap, min=2), 2, Zcap + 1)
            B_pk = peaks_dev.shape[1]
            if B_pk < S_pad:
                pkm_all = torch.nn.functional.pad(
                    peaks_dev[0], (0, 0, 0, S_pad - B_pk), value=np.inf
                )
                pki_all = torch.nn.functional.pad(
                    peaks_dev[1], (0, 0, 0, S_pad - B_pk), value=-1.0
                )
            else:
                pkm_all = peaks_dev[0][:S_pad]
                pki_all = peaks_dev[1][:S_pad]
            # the kernel reads each live slot's ladder row of lad_full and
            # its spectrum's peak row itself; the dead slots (past cnt_s,
            # masked out of every consumer below) come back as zeros
            mb, my, sb, sy, pp, lb, ly = rescore_indexed(
                tables.lad_full, pep_s,
                torch.arange(S_pad, dtype=i32, device=dev), pkm_all,
                pki_all, c_maxz, cnt_s,
                series=series, frag_tol=frag_tol, Z=Zb,
            )

            # ---- per-spectrum selection by the f32 hyperscore order key.
            # hs32 tracks hyperscore_vec's f64 arithmetic term for term
            # (scoring.rs:179-201); only its ORDER is consumed, and the
            # host guard bounds the f32/f64 divergence.
            lmb = lnf[mb.to(torch.int64)]
            lmy = lnf[my.to(torch.int64)]
            if openms:
                hs32 = torch.log1p(sb + sy) + lmb + lmy
            else:
                hs32 = torch.log(sb + 1.0) + torch.log(sy + 1.0) + lmb + lmy
            hs32 = torch.where(torch.isfinite(hs32), hs32, 255.0)
            # selection order (ok desc, hs32 desc, rank asc): a stable
            # ascending argsort of -key keeps rank order among ties. -key
            # is never +0.0 (hs32 is never -0.0), so IEEE order and the
            # total order of the JAX package's sort agree.
            ok = mask & ((mb + my) >= min_matched)
            nkey = -torch.where(ok, hs32, -np.inf)
            order = torch.argsort(nkey, dim=1, stable=True)

            def srt(x):
                return torch.gather(x, 1, order)

            skey = srt(nkey)
            s_mb, s_my, s_lb, s_ly = srt(mb), srt(my), srt(lb), srt(ly)
            s_z, s_iso, s_pep = srt(z_s), srt(iso_s), srt(pep_s)
            s_sb, s_sy, s_pp = srt(sb), srt(sy), srt(pp)
            sel_col = order[:, :Ksel].to(i32)             # [S_pad, Ksel]
            n_ok = ok.sum(dim=1, dtype=i32)
            # best UNSELECTED key per spectrum: the host-side safety bound
            b32 = (
                -skey[:, Ksel] if Ksel < K0
                else torch.full((S_pad,), -np.inf, dtype=torch.float32,
                                device=dev)
            )

            # ---- packed small output: Ksel selected rows per spectrum,
            # one stats row per spectrum, one tail row. Integer fields
            # bit-pack into f32-exact 24-bit lanes (preconditions checked
            # in _fused_dispatch: pep < 2^24, mb/my < 2^12, lb/ly < 2^6,
            # rank < 2^7, z < 2^5, |iso| <= 16):
            #   col0 mb*4096+my   col1 lb<<13 | ly<<7 | rank
            #   col2 z<<5 | iso+16  col3 pep  col4 sb  col5 sy  col6 ppm
            f32 = torch.float32
            cA = (s_mb[:, :Ksel] * 4096 + s_my[:, :Ksel]).to(f32)
            cB = (
                s_lb[:, :Ksel] * (1 << 13) + s_ly[:, :Ksel] * (1 << 7)
                + sel_col
            ).to(f32)
            cC = (s_z[:, :Ksel] * (1 << 5) + (s_iso[:, :Ksel] + 16)).to(f32)
            rows7 = torch.stack(
                [cA, cB, cC, s_pep[:, :Ksel].to(f32),
                 s_sb[:, :Ksel], s_sy[:, :Ksel], s_pp[:, :Ksel]],
                dim=-1,
            ).reshape(S_pad * Ksel, 7)
            # per-spectrum stats: b32, n_ok, matched_total, scored,
            # compact offset/count (the fallback's slice bounds)
            stats = torch.stack(
                [b32, n_ok.to(f32), mtot_s, scored_s, offs.to(f32),
                 cnt_s.to(f32), torch.zeros(S_pad, dtype=f32, device=dev)],
                dim=1,
            )  # [S_pad, 7]
            tail = torch.zeros((1, 7), dtype=f32, device=dev)
            tail[0, 0] = total.to(f32)
            if tail_extra is not None:
                n_x = min(int(tail_extra.shape[0]), 6)
                tail[0, 1 : 1 + n_x] = tail_extra[:n_x].to(f32)
            small = torch.cat([rows7, stats, tail], dim=0)

            # ---- untruncated per-item arrays, kept ON DEVICE for the
            # guard-failure fallback; spectrum s's items are rows
            # s*K0 .. s*K0+cnt_s
            spec_ids = torch.arange(S_pad, dtype=i32, device=dev)[:, None]
            items7 = torch.stack(
                [mb.to(f32), my.to(f32), sb, sy, pp, lb.to(f32), ly.to(f32)],
                dim=-1,
            ).reshape(S_pad * K0, 7)
            meta = torch.stack(
                [pep_s, z_s, iso_s, spec_ids.expand(S_pad, K0)], dim=-1,
            ).reshape(S_pad * K0, 4)
            return small, items7, meta

        return run_inner

    def _sticky_classes(self, rows, n_rows, W):
        """(Wb, Lcb) stage-1 classes for the fused plan, STICKY per
        (W, L): derived from `_row_buckets` on the first batch and
        reused verbatim afterwards, so the segment shapes stay stable
        across batches. The top class is widened to (W, L) as a
        catch-all so any later row fits."""
        L = self.tables.L
        key = (W, L)
        cls = self._plan_sticky.get(key)
        if cls is None:
            buckets = self._row_buckets(rows, n_rows, W)
            cls = (
                sorted({(int(b[0]), int(b[1] if b[1] is not None else L))
                        for b in buckets})
                if buckets else []
            )
            if (W, L) not in cls:
                cls.append((W, L))
            cls = tuple(sorted(cls))
            # only a SUBSTANTIAL batch may pin the sticky set: a tiny
            # or trailing first batch would degenerate to the (W, L)
            # catch-all and permanently forfeit the 2D bucketing win
            if n_rows >= 1024:
                self._plan_sticky[key] = cls
        return cls

    def _lens_blk(self):
        if getattr(self, "_lens_blk_cache", None) is None:
            self._lens_blk_cache = _lens_blockmax(self.db.table.lens)
        return self._lens_blk_cache

    def _ksel(self) -> int:
        """Selected rows fetched per spectrum: the reported PSMs, the
        runner-up delta_next needs, plus headroom for isotope-error
        twins and f32 near-ties."""
        import os

        env = os.environ.get("SAGE_TPU_KSEL")
        if env:
            return max(int(env), self.params.report_psms + 1)
        p = self.params
        n_iso = max(p.max_isotope_err - p.min_isotope_err + 1, 1)
        return p.report_psms + n_iso + 14

    def _ksel_open(self) -> int:
        """Open-search selection depth: wide windows give dense near-tie
        clusters at the boundary, so a deeper fetch cuts guard
        fallbacks."""
        return self._ksel() + 5

    def _fused_dispatch(self, spectra, cols, peaks_dev, rows=None):
        """Plan the batch's stage-1 segments (narrow) or open-search
        pseudo-segments, launch them and the merge pass; returns the
        dispatch dict that _fused_finalize consumes, or None where the
        fused path's preconditions do not hold (the caller takes the
        two-dispatch path). ``cols``: the batch's ``BatchColumns``; only
        the open regime's plan reads its host-padded masses."""
        import os

        p = self.params
        # bit-packing preconditions (see _build_fused's output layout)
        if (
            len(self.db) >= (1 << 24)
            or self.tables.L >= 64
            or self.K >= 128  # merge rank must fit its 7-bit lane
            or p.max_precursor_charge >= 32
            or p.min_isotope_err < -16
            or p.max_isotope_err > 15
        ):
            return None
        if os.environ.get("SAGE_TPU_FUSED", "1") == "0":
            return None
        Pk = cols.Pk
        if rows is None:
            rows = self._expand_rows(spectra)
        # file-annotated precursor charges bypass max_precursor_charge, so
        # the 5-bit charge lane must be checked against the actual rows
        n_rows = rows["si"].size
        if n_rows == 0 or int(rows["z"].max()) >= 32:
            return None
        n_spec = len(spectra)
        max_win = int((rows["i1"] - rows["i0"]).max())
        W = min(next_power_of_two(max(max_win, 8)), self.tables.P_pad)
        open_regime = self._open_path(W)
        nb = None if open_regime else self._narrow_banded_maybe(W)

        S_pad = _pad_count(n_spec)
        si = rows["si"]
        # within-spectrum row ordinal (rows are spectrum-grouped); the
        # merge grid slot coordinate — rows per spectrum may be ragged
        starts = np.r_[0, np.flatnonzero(np.diff(si)) + 1]
        counts_r = np.diff(np.r_[starts, n_rows])
        slot = (np.arange(n_rows) - np.repeat(starts, counts_r)).astype(
            np.int32
        )
        G_eff = next_power_of_two(max(int(slot.max()) + 1, 1))

        cfg = p.max_fragment_charge
        cap = np.minimum(rows["z"], cfg + 1) if cfg is not None else rows["z"]
        maxz = np.maximum(cap, 2)
        Zb = min(max(int(maxz.max()) - 1, 1), self.Z)

        open_sticky = None
        if open_regime:
            planned = self._open_plan(
                cols.masses, rows, peaks_dev, S_pad, slot, starts, counts_r,
                maxz, Zb, G_eff,
            )
            if planned is None:
                return None
            plan, ints, G_eff, open_segs, open_sticky = planned
            Ksel = min(self._ksel_open(), self.K)
        elif nb is not None:
            # the banded stage 1: one pseudo-segment over every row in
            # original order
            plan = (("banded", n_rows),)
            ints = _open_ints(n_rows, S_pad, rows, np.arange(n_rows), maxz,
                              slot)
            Ksel = min(self._ksel(), self.K)
        else:
            plan, ints, segs = self._narrow_plan(rows, S_pad, slot, maxz, Zb,
                                                 W)
            Ksel = min(self._ksel(), self.K)
        R_tot = ints.shape[1]
        # spectrum-major slot -> global stage-1 row permutation: the merge
        # GATHERS rows into its [S_pad, G_eff] grid; empty slots point at
        # the all-zero sentinel row
        perm = np.full(S_pad * G_eff, R_tot, np.int64)
        live_r = ints[0] < S_pad
        perm[
            ints[0, live_r].astype(np.int64) * G_eff + ints[7, live_r]
        ] = np.flatnonzero(live_r)
        perm_dev = _to_dev(perm, self.device)
        ints_dev = _to_dev(ints, self.device)

        # a device-planned open batch's overflow statistics ride the tail row
        tail_extra = open_sticky.pop("stats") if open_sticky else None
        seg_outs = []
        nb_F = None
        if open_regime:
            for seg in open_segs:
                seg_outs.append(self._open_count(seg, Zb))
        elif nb is not None:
            # the largest per-spectrum entry count rides the tail row
            packed_b, tail_extra, nb_F, nbcov = nb.dispatch(
                peaks_dev, rows, ints_dev, n_rows, Zb,
                self.params.fragment_tol, Pk,
            )
            seg_outs.append(packed_b)
            self.last_plan = {
                "banded": True, "W": W, "nbcov": nbcov, "F": nb_F,
                "n_bands": nb.n_bands, "band_w": nb.band_w, "G_eff": G_eff,
                "Zb": Zb, "S_pad": S_pad, "Ksel": Ksel,
            }
        else:
            off = 0
            for (Wb, Lcb, Rb, Zc), idx_p in zip(plan, segs):
                if idx_p.size == 0:
                    # empty segment (the sticky catch-all class, or a
                    # z-split side with no rows this batch): a cached zero
                    # output — the merge's perm never references its rows
                    cols = (Wb + 2) if Wb <= self.K else (2 * self.K + 2)
                    zkey = ("zeros", Rb, cols)
                    if zkey not in self._cache:
                        self._cache[zkey] = torch.zeros(
                            (Rb, cols), dtype=torch.int32, device=self.device
                        )
                    seg_outs.append(self._cache[zkey])
                else:
                    run_b, _co = self._stage1(Wb, Pk, Rb, Zc, Lcb)
                    seg_outs.append(
                        run_b(peaks_dev,
                              ints_dev[:5, off : off + Rb].contiguous())
                    )
                off += Rb
            self.last_plan = {
                "plan": plan, "seg_rows": [int(s.size) for s in segs],
                "G_eff": G_eff, "Zb": Zb, "W": W, "S_pad": S_pad,
                "Ksel": Ksel,
            }
        fkey = ("fused", plan, Pk, S_pad, G_eff, Zb, Ksel)
        if fkey not in self._cache:
            self._cache[fkey] = self._build_fused(
                plan, Pk, S_pad, G_eff, Zb, Ksel
            )
        small, items7, meta = self._cache[fkey](
            peaks_dev, ints_dev, perm_dev, seg_outs, tail_extra
        )
        return {
            "fused": small, "items7": items7, "meta": meta,
            "n_rows": n_rows, "n_spec": n_spec,
            "Ksel": Ksel, "S_pad": S_pad, "open_sticky": open_sticky,
            "nb_F": nb_F,
        }

    def _narrow_plan(self, rows, S_pad, slot, maxz, Zb, W):
        """The narrow regime's 2D (width, ladder-length) class plan:
        sticky classes, quarter-octave per-class row counts. Returns the
        plan's (Wb, Lcb, Rb, Zc) segments, the [8, R_tot] row table and
        each segment's row indices."""
        n_rows = rows["si"].size
        width = (rows["i1"] - rows["i0"]).astype(np.int64)
        lneed = _window_lneed(
            self.db.table.lens, rows["i0"], rows["i1"],
            blkmax=self._lens_blk(),
        )
        classes = self._sticky_classes(rows, n_rows, W)
        assign = np.full(n_rows, -1, np.int64)
        for ci, (Wb, Lcb) in enumerate(classes):
            m = (assign < 0) & (width <= Wb) & (lneed <= Lcb)
            assign[m] = ci

        plan = []
        segs = []
        for ci, (Wb, Lcb) in enumerate(classes):
            idx = np.flatnonzero(assign == ci)
            if Zb > 1:
                # z-split: rows whose fragment-charge bound is 2
                # (charge-2 precursors) never populate the z>=2 compare
                # planes — give them a Zc=1 segment. Both sub-segments
                # always exist so the plan's shape set stays stable.
                parts2 = [(idx[maxz[idx] <= 2], 1), (idx[maxz[idx] > 2], Zb)]
            else:
                parts2 = [(idx, Zb)]
            for idx_p, Zc in parts2:
                plan.append((Wb, Lcb, _quarter_octave(max(idx_p.size, 8)), Zc))
                segs.append(idx_p)
        plan = tuple(plan)
        ints = np.zeros((8, sum(e[2] for e in plan)), dtype=np.int32)
        ints[0] = S_pad  # padding sentinel
        ints[4] = 2
        off = 0
        for (Wb, Lcb, Rb, _Zc), idx in zip(plan, segs):
            sl = slice(off, off + idx.size)
            ints[1, sl] = np.minimum(rows["i0"][idx], self.tables.P_pad - Wb)
            _fill_rows(ints, sl, rows, idx, maxz, slot[idx])
            off += Rb
        return plan, ints, segs

    def _open_plan(self, masses, rows, peaks_dev, S_pad, slot, starts,
                   counts_r, maxz, Zb, G_eff):
        """The open regime's plan: one or more ("banded", R_b)
        pseudo-segments whose count core produces the [R_b, 2K+2] top-K
        layout. The first batch and an oversized one plan on the
        host (searchsorted ranges); every other batch plans its ranges on
        the device under the sticky shapes that the host-planned batches
        recorded, in one class or in up to three slot size classes, with
        a device-computed overflow check (``open_sticky``, read by
        _fused_finalize). Returns (plan, ints, G_eff, open_segs,
        open_sticky), or None for a batch past the element budget after
        one split level."""
        os_ = self._open_searcher()
        n_spec = masses.shape[0]
        n_rows = rows["si"].size
        si = rows["si"]
        stk = os_._sticky_shapes
        u0, u1 = spectrum_window_union(rows, n_spec)
        b0_u, _b1, nbc = covered_bands(u0, u1, os_.band_w, os_.n_bands,
                                       n_spec)
        open_sticky = None
        if stk is not None:
            # class-aware element budget: each live (spectrum, band) slot
            # rides its own size class
            classes = stk["classes"]
            eb_pred, valid_b = os_.est_band_sizes(masses, u0, u1)
            ci = os_.assign_classes(eb_pred)
            if ci is None:
                elems = n_spec * nbc * stk["F"]
            else:
                cif = ci[valid_b]
                elems = sum(int((cif == c).sum()) * classes[c]["F"]
                            for c in range(len(classes)))
            if elems <= os_.MAX_ELEMENTS:
                open_sticky = dict(stk)
        if open_sticky is None:
            return self._open_host_plan(os_, masses, rows, S_pad, slot,
                                        maxz, Zb, G_eff, u0, u1)

        chunked = open_sticky["chunked"]
        classes = open_sticky["classes"]
        segs, plan_l, stats_l, ints_cols = [], [], [], []
        open_sticky.update(cls_of_side=[], F_effs=[], Wcs=[])

        def add_side(c, seg, stats, cols):
            cl = classes[c]
            F_b = min(cl["F"], cl["Wc"] * V_ROW) if chunked else cl["F"]
            seg.update(F_b=F_b, Wc_b=cl["Wc"], chunked=chunked)
            segs.append(seg)
            plan_l.append(("banded", seg["R_b"]))
            stats_l.append(stats)
            ints_cols.append(cols)
            open_sticky["cls_of_side"].append(c)
            open_sticky["F_effs"].append(F_b)
            open_sticky["Wcs"].append(cl["Wc"])

        # membership needs a calibrated multi-class state and at least
        # one live slot; otherwise (every class empty included) the whole
        # batch takes the single-class layout
        if ci is None or not valid_b.any():
            # single class: the band-major count core over the [B, nbcov]
            # grid, ranges from the grid probe
            st_dev, ln_dev, nbc = os_.ranges_device(peaks_dev, u0, u1, Zb)
            Pk_eff = int(st_dev.shape[1]) // max(Zb * nbc, 1)
            idx = np.arange(n_rows)
            seg = self._open_rows(idx, si, rows, maxz)
            seg.update(starts=st_dev, lens=ln_dev, Pk_eff=Pk_eff, nbcov=nbc)
            cols = _open_ints(seg["R_b"], S_pad, rows, idx, maxz, slot[idx])
            add_side(len(classes) - 1, seg,
                     _range_stats(st_dev, ln_dev, nbcov=nbc, Zb=Zb,
                                  Pk=Pk_eff), cols)
        else:
            # each live (spectrum, band) slot becomes a pseudo-row of the
            # class that fits its estimate; the range probe runs slot-major
            # over live slots only, and the merge recombines a spectrum's
            # slots exactly
            Pk_eff = int(masses.shape[1])
            ci_flat = ci.reshape(-1)
            live = valid_b.reshape(-1)
            for c in range(len(classes)):
                slot_ids = np.flatnonzero(live & (ci_flat == c))
                if slot_ids.size == 0:
                    continue
                s_arr = slot_ids // nbc
                k_arr = slot_ids % nbc
                # quarter-octave padded slot axis; padding slots are
                # invalid and probe to all-zero ranges
                n_sl = slot_ids.size
                NS_pad = _quarter_octave(max(n_sl, 8))
                spec_p = np.zeros(NS_pad, np.int64)
                band_p = np.zeros(NS_pad, np.int64)
                valid_p = np.zeros(NS_pad, bool)
                spec_p[:n_sl] = s_arr
                band_p[:n_sl] = np.clip(b0_u[s_arr] + k_arr, 0,
                                        os_.n_bands - 1)
                valid_p[:n_sl] = True
                # pseudo-rows: every query row of each slot's spectrum
                cnts = counts_r[s_arr]
                n_ps = int(cnts.sum())
                cum0 = np.concatenate([[0], np.cumsum(cnts)[:-1]])
                r_idx = (np.repeat(starts[s_arr], cnts)
                         + (np.arange(n_ps) - np.repeat(cum0, cnts))
                         ).astype(np.int64)
                seg = self._open_rows(
                    r_idx, np.repeat(np.arange(n_sl), cnts), rows, maxz,
                    sentinel=n_sl,
                )
                st_c, ln_c = os_.ranges_device_slots(
                    peaks_dev, spec_p, band_p, valid_p, Zb
                )
                seg.update(starts=st_c, lens=ln_c, Pk_eff=Pk_eff, nbcov=1)
                # merge coordinates: one slot per (query row, band)
                cols = _open_ints(
                    seg["R_b"], S_pad, rows, r_idx, maxz,
                    slot[r_idx] * nbc + np.repeat(k_arr, cnts),
                )
                add_side(c, seg,
                         _range_stats(st_c, ln_c, nbcov=1, Zb=Zb, Pk=Pk_eff),
                         cols)
            # merge-grid slots are (query row, band) pairs now
            G_eff = next_power_of_two(
                max((int(slot.max(initial=0)) + 1) * nbc, 1)
            )
        open_sticky["stats"] = torch.cat(stats_l)
        open_sticky["os"] = os_
        self._note_open_plan(os_, True, nbc, plan_l, segs)
        return (tuple(plan_l), np.concatenate(ints_cols, axis=1), G_eff, segs,
                open_sticky)

    def _open_host_plan(self, os_, masses, rows, S_pad, slot, maxz, Zb,
                        G_eff, u0, u1):
        """Host-planned open batch: searchsorted ranges, at most one split
        level (two pseudo-segments), and the sticky shapes and slot size
        classes that later batches plan under. None where a split side is
        still past the element budget: the recursive split runs through
        the two-dispatch path."""
        n_spec = masses.shape[0]
        n_rows = rows["si"].size
        si = rows["si"]
        g_starts, g_lens, Pk_eff, chunked, size, Wc, _F, nbcov_g = (
            os_._geometry(masses, rows, Zb, None)
        )
        split = os_._find_split(n_spec, size, nbcov_g)
        if split is not None:
            # one split level is two pseudo-segments; deeper recursion
            # goes through the two-dispatch path
            for s_ids in (np.flatnonzero(split), np.flatnonzero(~split)):
                if s_ids.size and (
                    s_ids.size * nbcov_g * (int(size[s_ids].max()) + 1)
                    > os_.MAX_ELEMENTS
                ):
                    return None
        # per-spectrum max over covered bands of that band's entry count:
        # the unit the band-major count core pads F to
        tot_sb = g_lens.reshape(n_spec, Zb, nbcov_g, Pk_eff).sum(axis=(1, 3))
        totals = tot_sb.max(axis=1)
        g_ends = g_starts + g_lens
        rows_sb = np.where(
            g_lens > 0,
            (g_ends + (V_ROW - 1)) // V_ROW - g_starts // V_ROW,
            0,
        ).reshape(n_spec, Zb, nbcov_g, Pk_eff).sum(axis=(1, 3))
        eb_t, valid_t = os_.est_band_sizes(masses, u0, u1)
        os_.note_shapes(
            chunked, Wc, int(totals.max(initial=0)),
            slot_sizes=tot_sb.astype(np.float64), slot_ests=eb_t,
            slot_valid=valid_t, slot_rows=rows_sb.astype(np.float64),
        )
        sides = (
            [np.arange(n_spec)] if split is None
            else [np.flatnonzero(split), np.flatnonzero(~split)]
        )
        segs, plan_l, ints_cols = [], [], []
        for spec_ids in sides:
            whole = len(sides) == 1
            rows_idx = (np.arange(n_rows) if whole
                        else np.flatnonzero(np.isin(si, spec_ids)))
            if chunked:
                tc_b = size[spec_ids] // V_ROW
                Wc_b = _quarter_octave(max(int(tc_b.max(initial=8)), 8))
            else:
                Wc_b = 8
            F_b = _quarter_octave(int(totals[spec_ids].max(initial=0)) + 1)
            F_b = ((max(F_b, self.K, 128) + 127) // 128) * 128
            if chunked:
                F_b = min(F_b, Wc_b * V_ROW)
            remap = np.full(n_spec, -1, np.int64)
            remap[spec_ids] = np.arange(spec_ids.size)
            seg = self._open_rows(rows_idx, remap[si[rows_idx]], rows, maxz,
                                  sentinel=spec_ids.size)
            seg.update(
                F_b=F_b, Wc_b=Wc_b, chunked=chunked, Pk_eff=Pk_eff,
                nbcov=nbcov_g,
                starts=g_starts if whole else g_starts[spec_ids],
                lens=g_lens if whole else g_lens[spec_ids],
            )
            segs.append(seg)
            plan_l.append(("banded", seg["R_b"]))
            ints_cols.append(_open_ints(seg["R_b"], S_pad, rows, rows_idx,
                                        maxz, slot[rows_idx]))
        self._note_open_plan(os_, False, nbcov_g, plan_l, segs)
        return (tuple(plan_l), np.concatenate(ints_cols, axis=1), G_eff, segs,
                None)

    @staticmethod
    def _open_rows(idx, lspec_real, rows, maxz, sentinel=None):
        """The count core's query-row inputs for one pseudo-segment: rows
        ``idx`` of the batch, each reading pseudo-row ``lspec_real``,
        padded to a power of two with rows of spectrum ``sentinel``
        (default: the batch size) and an empty [0, 0) window."""
        n = idx.size
        R_b = next_power_of_two(max(n, 8))
        lspec = np.full(R_b, rows["si"].size if sentinel is None
                        else sentinel, np.int32)
        li0 = np.zeros(R_b, np.int32)
        li1 = np.zeros(R_b, np.int32)
        lmz = np.full(R_b, 2, np.int32)
        lspec[:n] = lspec_real
        li0[:n] = rows["i0"][idx]
        li1[:n] = rows["i1"][idx]
        lmz[:n] = maxz[idx]
        return {"R_b": R_b, "lspec": lspec, "li0": li0, "li1": li1,
                "lmz": lmz}

    def _open_count(self, seg, Zb):
        """Launch one open pseudo-segment's count core."""
        os_ = self._open_searcher()

        def dev(a):
            return a if isinstance(a, torch.Tensor) else _to_dev(a,
                                                                 self.device)

        return _device_open_count(
            os_.frag_pep8_dev, dev(seg["starts"]), dev(seg["lens"]),
            dev(seg["lspec"]), dev(seg["li0"]), dev(seg["li1"]),
            dev(seg["lmz"]),
            F=seg["F_b"], Wc=seg["Wc_b"], Pk=seg["Pk_eff"], Z=Zb, K=self.K,
            R=seg["R_b"], chunked=seg["chunked"], nbcov=seg["nbcov"],
            n_pep=os_.n_pep,
        )

    def _note_open_plan(self, os_, device_planned, nbcov, plan, segs):
        self.last_plan = {
            "open": True, "device_planned": device_planned,
            "n_bands": os_.n_bands, "nbcov": nbcov, "plan": tuple(plan),
            "F": [s["F_b"] for s in segs], "Wc": [s["Wc_b"] for s in segs],
            "chunked": bool(segs[0]["chunked"]) if segs else None,
            "classes": (
                [dict(c) for c in os_._sticky_shapes["classes"]]
                if os_._sticky_shapes else None
            ),
        }

    def _fused_finalize(self, d, cols, packed=None):
        """Unpack the fused-select fetch into the final FeatureTable
        (``cols``: the batch's ``BatchColumns``).

        Exactness: the device selected each spectrum's top-Ksel
        candidates by an f32 hyperscore ORDER key; this host side
        recomputes exact f64 hyperscores for the fetched rows, re-sorts,
        and verifies per spectrum that no unfetched candidate (whose f32
        key is bounded by the fetched ``b32``) could reach the reported
        set. Spectra that trip the guard are recomputed from the
        untruncated on-device candidate arrays.

        Returns None, for the caller to score the batch again through the
        two-dispatch path, when a device-planned open batch overflowed
        its sticky shapes or a banded batch's entries reached its capacity
        F (either may have truncated entries; the shapes or F grow
        first), and when a per-spectrum sum reached 2^24."""
        if packed is None:
            with trace.span("search.fetch"):
                packed = d["fused"].cpu().numpy()
        if d.get("nb_F") is not None:
            totmax = int(packed[-1, 1])
            if totmax >= d["nb_F"]:
                # entries past F were dropped: grow F, redo the batch
                self._nb.grow_F(totmax)
                log.info(
                    "banded narrow stage-1 entry capacity %d exceeded (max "
                    "%d); growing", d["nb_F"], totmax,
                )
                return None
        ost = d.get("open_sticky")
        if ost is not None:
            # the device reported each size class's true max per-(spectrum,
            # band) entry and gather-row totals through the tail row
            bad = False
            for i, c in enumerate(ost["cls_of_side"]):
                tot_e = int(packed[-1, 1 + 2 * i])
                tot_r = int(packed[-1, 2 + 2 * i])
                if tot_e >= ost["F_effs"][i] or (
                    ost["chunked"] and tot_r > ost["Wcs"][i]
                ):
                    ost["os"].grow_shapes(tot_e, tot_r, ci=c)
                    log.info(
                        "open sticky class %d shapes exceeded (entries %d "
                        "vs F %d, rows %d vs Wc %d); growing", c, tot_e,
                        ost["F_effs"][i], tot_r, ost["Wcs"][i],
                    )
                    bad = True
            if bad:
                return None
        S_pad, Ksel = d["S_pad"], d["Ksel"]
        n_spec = d["n_spec"]
        p = self.params
        r_psms = p.report_psms
        rows7 = packed[: S_pad * Ksel].reshape(S_pad, Ksel, 7)[:n_spec]
        stats = packed[S_pad * Ksel : S_pad * Ksel + S_pad][:n_spec]

        b32 = stats[:, 0]
        n_ok = stats[:, 1].astype(np.int64)
        spec_matched = stats[:, 2].astype(np.int64)
        spec_scored = stats[:, 3].astype(np.int64)
        offs = stats[:, 4].astype(np.int64)
        cnt = stats[:, 5].astype(np.int64)
        # per-spectrum sums were accumulated in f32 on device: past 2^24
        # they lose integer exactness
        if stats[:, 2:4].max(initial=0.0) >= float(1 << 24):
            return None

        # unpack the selected rows (see _build_fused's packed layout)
        cA = rows7[..., 0].astype(np.int64)
        cB = rows7[..., 1].astype(np.int64)
        cC = rows7[..., 2].astype(np.int64)
        mb = (cA // 4096).astype(np.int32)
        my = (cA % 4096).astype(np.int32)
        lb = (cB >> 13).astype(np.int32)
        ly = ((cB >> 7) & 63).astype(np.int32)
        mrank = (cB & 127).astype(np.int32)  # within-spectrum merge rank
        zc = (cC >> 5).astype(np.int32)
        iso = ((cC & 31) - 16).astype(np.int32)
        pep = rows7[..., 3].astype(np.int32)
        sb = rows7[..., 4].astype(np.float32)
        sy = rows7[..., 5].astype(np.float32)
        pps = rows7[..., 6].astype(np.float32)

        n_fetch = np.minimum(n_ok, Ksel)  # valid fetched rows/spectrum
        col = np.arange(Ksel, dtype=np.int64)[None, :]
        valid = col < n_fetch[:, None]

        # exact f64 hyperscore + host re-sort of the fetched rows by
        # (hs desc, merge rank asc) — the classic lexsort's exact order
        hs = hyperscore_vec(p.score_type, mb, my, sb, sy)
        hs = np.where(valid, hs, -np.inf)
        order = np.lexsort(
            (np.where(valid, mrank, 1 << 20), -hs), axis=1
        )
        take = np.take_along_axis

        def srt(x):
            return take(x, order, axis=1)

        hs_s = srt(hs)
        # the guard: every reported row and its delta_next source must
        # beat the best unselected candidate's f32 key by the f32/f64
        # divergence margin (spectra whose candidates were all fetched
        # are exact by construction)
        n_need = np.minimum(n_ok, r_psms + 1)
        last_needed = np.clip(n_need - 1, 0, Ksel - 1)
        need_hs = take(hs_s, last_needed[:, None], axis=1)[:, 0]
        with np.errstate(invalid="ignore"):
            # -inf + inf -> nan when the guard is forced wide open; the
            # nan compares False, i.e. falls back — the safe direction
            safe = (n_ok <= Ksel) | (need_hs > b32 + self.SELECT_EPS)
        failed = np.flatnonzero(~safe & (n_ok > 0))

        n_rep = np.minimum(n_ok, r_psms).astype(np.int64)
        rep_mask = col < n_rep[:, None]
        # delta_next: vs the next candidate in hs order (0 past the end)
        nxt = np.concatenate(
            [hs_s[:, 1:], np.full((hs_s.shape[0], 1), -np.inf)], axis=1
        )
        has_next = col + 1 < n_ok[:, None]
        with np.errstate(invalid="ignore"):
            # invalid slots hold -inf; their nan deltas are never read
            delta_next = hs_s - np.where(has_next, nxt, 0.0)
            delta_best = hs_s[:, :1] - hs_s

        top = {
            "pep": srt(pep), "z": srt(zc), "iso": srt(iso),
            "mb": srt(mb), "my": srt(my), "sb": srt(sb), "sy": srt(sy),
            "pps": srt(pps), "lb": srt(lb), "ly": srt(ly),
        }

        if failed.size:
            self._select_fallback(
                failed, d, n_ok, r_psms, top, hs_s, delta_next,
                delta_best, offs=offs, cnt=cnt,
            )

        ri, ci = np.nonzero(rep_mask)
        ssum = (top["sb"][ri, ci] + top["sy"][ri, ci]).astype(np.float32)
        ppm_sum = top["pps"][ri, ci]
        ppm = np.where(
            ssum != 0,
            ppm_sum / np.where(ssum == 0, np.float32(1.0), ssum),
            0.0,
        ).astype(np.float32)
        return self._emit_table(
            cols,
            s_of=ri.astype(np.int32), pep=top["pep"][ri, ci],
            z_of=top["z"][ri, ci], iso_i=top["iso"][ri, ci],
            mb=top["mb"][ri, ci], my=top["my"][ri, ci],
            sb=top["sb"][ri, ci], sy=top["sy"][ri, ci], ppm=ppm,
            lb=top["lb"][ri, ci], ly=top["ly"][ri, ci],
            hs=hs_s[ri, ci], rank0=ci.astype(np.int32),
            delta_next=delta_next[ri, ci], delta_best=delta_best[ri, ci],
            spec_matched=spec_matched, spec_scored=spec_scored,
            tic_override=None,
        )

    def _select_fallback(
        self, failed, d, n_ok, r_psms, cols, hs_s, delta_next, delta_best,
        offs, cnt,
    ):
        """Recompute the reported rows of guard-failed spectra from the
        untruncated on-device candidate arrays, overwriting the
        fetched-row views in place. Only the failed spectra's compact
        ranges are gathered on the device and fetched, in one copy."""
        log.debug(
            "select guard: %d spectra fall back to the full candidate "
            "list", failed.size,
        )
        self.select_fallback_spectra = (
            getattr(self, "select_fallback_spectra", 0) + int(failed.size)
        )
        p = self.params
        min_m = p.min_matched_peaks
        take_idx = np.concatenate(
            [np.arange(offs[s], offs[s] + cnt[s]) for s in failed]
        )
        idx_dev = _to_dev(take_idx.astype(np.int64), self.device)
        with trace.span("search.fetch"):
            g7 = d["items7"][idx_dev].cpu().numpy()
            g4 = d["meta"][idx_dev].cpu().numpy()
        items7 = np.zeros((int(take_idx.max(initial=0)) + 1, 7), np.float32)
        meta = np.zeros((items7.shape[0], 4), np.int32)
        items7[take_idx] = g7
        meta[take_idx] = g4
        for s in failed:
            sel = np.arange(offs[s], offs[s] + cnt[s])
            if sel.size == 0:
                continue
            f_mb = items7[sel, 0].astype(np.int32)
            f_my = items7[sel, 1].astype(np.int32)
            f_sb = items7[sel, 2]
            f_sy = items7[sel, 3]
            ok = (f_mb + f_my) >= min_m
            oi = np.flatnonzero(ok)
            f_hs = hyperscore_vec(
                p.score_type, f_mb[oi], f_my[oi], f_sb[oi], f_sy[oi]
            )
            # stable by (hs desc) keeps merge order for ties — `sel` is
            # already in within-spectrum merge-rank order
            o2 = np.argsort(-f_hs, kind="stable")
            src = sel[oi[o2]]
            k = min(src.size, hs_s.shape[1])
            n_ok[s] = oi.size
            for name, src_col in (
                ("mb", 0), ("my", 1), ("sb", 2), ("sy", 3), ("pps", 4),
                ("lb", 5), ("ly", 6),
            ):
                dst = cols[name]
                dst[s, :k] = items7[src[:k], src_col].astype(dst.dtype)
            cols["pep"][s, :k] = meta[src[:k], 0]
            cols["z"][s, :k] = meta[src[:k], 1]
            cols["iso"][s, :k] = meta[src[:k], 2]
            hs_sorted = f_hs[o2]
            hs_s[s, :k] = hs_sorted[:k]
            for j in range(min(k, r_psms)):
                delta_next[s, j] = hs_sorted[j] - (
                    hs_sorted[j + 1] if j + 1 < oi.size else 0.0
                )
                delta_best[s, j] = hs_sorted[0] - hs_sorted[j]

    # ------------------------------------------------------------------
    # Two-dispatch path: stage 1 + host merge, then stage 2 + host select
    # ------------------------------------------------------------------

    def _preliminary(self, spectra, masses=None, peaks_dev=None):
        return self._prelim_finalize(
            self._prelim_dispatch(spectra, masses=masses, peaks_dev=peaks_dev)
        )

    def _prelim_dispatch(self, spectra, masses=None, peaks_dev=None,
                         rows=None):
        """Launch stage 1 for every query row: the width-bucketed
        (Wb, Lcb) segments, one segment at the batch's width, or the open
        search's count core. Returns the dispatch dict that
        _prelim_finalize fetches and merges."""
        p = self.params
        if rows is None:
            rows = self._expand_rows(spectra)
        if masses is None:
            masses, intens, Pk = self._pad_peaks(spectra)
            if peaks_dev is None:
                peaks_dev = self._peaks_device(masses, intens)
        else:
            Pk = masses.shape[1]
            if peaks_dev is None:
                peaks_dev = self._peaks_device(masses, np.zeros_like(masses))
        n_rows = rows["si"].size
        n_spec = len(spectra)

        max_win = int((rows["i1"] - rows["i0"]).max()) if n_rows else 1
        W = min(next_power_of_two(max(max_win, 8)), self.tables.P_pad)
        R = max(n_rows, 1)  # the kernels take any row count

        spec_idx = np.zeros(R, dtype=np.int32)
        row_z = np.zeros(R, dtype=np.int32)
        row_iso = np.zeros(R, dtype=np.int32)
        p0 = np.zeros(R, dtype=np.int32)
        i0a = np.zeros(R, dtype=np.int32)
        i1a = np.zeros(R, dtype=np.int32)
        maxz = np.full(R, 2, dtype=np.int32)
        spec_idx[:n_rows] = rows["si"]
        row_z[:n_rows] = rows["z"]
        row_iso[:n_rows] = rows["iso"]
        p0[:n_rows] = np.minimum(rows["i0"], self.tables.P_pad - W)
        i0a[:n_rows] = rows["i0"]
        i1a[:n_rows] = rows["i1"]
        cfg = p.max_fragment_charge
        cap = np.minimum(rows["z"], cfg + 1) if cfg is not None else rows["z"]
        maxz[:n_rows] = np.maximum(cap, 2)
        # a batch without rows keeps one row on an empty window, which
        # counts nothing

        # only the charge planes this batch can reach
        Zb = min(max(int(maxz[:n_rows].max()) - 1, 1), self.Z) if n_rows else 1
        if self._open_path(W):
            out_dev = self._open_searcher().preliminary_packed(
                masses, rows, maxz, R, Zb
            )
            return {
                "out_dev": out_dev, "counts_only": False,
                "n_rows": n_rows, "n_spec": n_spec, "W": W,
                "p0": p0, "spec_idx": spec_idx, "row_z": row_z,
                "row_iso": row_iso,
            }
        buckets = self._row_buckets(rows, n_rows, W)
        if buckets is None:
            buckets = [(W, None, np.arange(n_rows))]
        outs = []
        for Wb, Lcb, idx in buckets:
            # each (window-width, ladder-length) class at its own shape:
            # stage-1 work is proportional to W x Lc x rows
            nb = idx.size
            Rb = max(nb, 1)
            sub = np.zeros((7, Rb), np.int32)  # spec p0 i0 i1 maxz z iso
            sub[4] = 2
            sub[0, :nb] = spec_idx[idx]
            sub[1, :nb] = np.minimum(i0a[idx], self.tables.P_pad - Wb)
            sub[2, :nb] = i0a[idx]
            sub[3, :nb] = i1a[idx]
            sub[4, :nb] = maxz[idx]
            sub[5, :nb] = row_z[idx]
            sub[6, :nb] = row_iso[idx]
            run, counts_only = self._stage1(Wb, Pk, Rb, Zb, Lcb)
            outs.append({
                "out_dev": run(peaks_dev, _to_dev(sub[:5], self.device)),
                "counts_only": counts_only, "n_rows": nb, "W": Wb,
                "p0": sub[1], "spec_idx": sub[0], "row_z": sub[5],
                "row_iso": sub[6],
            })
        return {"buckets": outs, "n_spec": n_spec}

    @staticmethod
    def _prelim_part(d, K):
        """Fetch one stage-1 dispatch and unpack it into flat
        per-candidate arrays (m, pep, spec, z, iso) plus per-row (spec,
        mtot, scored). Stage 1 returns the exact layouts: the counts-only
        [R, W+2] window, or the [R, 2K+2] per-row top-K."""
        out = d["out_dev"]
        if isinstance(out, torch.Tensor):
            with trace.span("search.fetch"):
                out = out.cpu().numpy()
        n_rows, W = d["n_rows"], d["W"]
        p0, spec_idx = d["p0"], d["spec_idx"]
        expected = W + 2 if d["counts_only"] else 2 * K + 2
        if out.shape[1] != expected:
            raise AssertionError(
                f"stage-1 layout mismatch: out width {out.shape[1]} != "
                f"{expected} (counts_only={d['counts_only']}, W={W}, K={K})"
            )
        if d["counts_only"]:
            counts = out[:n_rows, :W]
            mtot, scored = out[:n_rows, W], out[:n_rows, W + 1]
            # the (vals, pep) layout of the top-K path: the whole window in
            # reversed candidate order (peptide desc)
            vals = counts[:, ::-1]
            pep = p0[:n_rows, None] + (W - 1 - np.arange(W, dtype=np.int32))
        else:
            vals = out[:n_rows, :K]
            pep = out[:n_rows, K : 2 * K]
            mtot, scored = out[:n_rows, 2 * K], out[:n_rows, 2 * K + 1]
        k_row = vals.shape[1]
        m = vals.ravel()
        pp = np.broadcast_to(pep, (n_rows, k_row)).ravel()
        ss = np.repeat(spec_idx[:n_rows], k_row)
        zz = np.repeat(d["row_z"][:n_rows], k_row)
        ii = np.repeat(d["row_iso"][:n_rows], k_row)
        return m, pp, ss, zz, ii, spec_idx[:n_rows], mtot, scored

    def _prelim_finalize(self, d):
        K = self.K
        n_spec = d["n_spec"]
        parts = [self._prelim_part(b, K) for b in d.get("buckets", (d,))]
        if len(parts) == 1:
            m, pp, ss, zz, ii, rspec, mtot, scored = parts[0]
        else:
            cols = [np.concatenate(c) for c in zip(*parts)]
            m, pp, ss, zz, ii, rspec, mtot, scored = cols

        # per-spectrum Poisson statistics (sums over the spectrum's rows)
        spec_matched = np.bincount(
            rspec, weights=mtot, minlength=n_spec
        ).astype(np.int64)
        spec_scored = np.bincount(
            rspec, weights=scored, minlength=n_spec
        ).astype(np.int64)

        # rank the flattened candidates per spectrum (zero-matched dropped)
        sel = merge_prescore_candidates(m, pp, ss, zz, ii, K)

        return {
            "cand_matched": m[sel].astype(np.int32),
            "cand_pep": pp[sel].astype(np.int32),
            "cand_spec": ss[sel].astype(np.int32),
            "cand_charge": zz[sel].astype(np.int32),
            "cand_iso": ii[sel].astype(np.int32),
            "spec_matched": spec_matched,
            "spec_scored": spec_scored,
        }

    def _features_table(self, cols, prelim, peaks_dev, report_psms=None,
                        removed_masks=None, tic_override=None,
                        batch=None) -> FeatureTable:
        """Stage 2 and the vectorized host feature assembly
        (scoring.rs:478-595, 675-767) of the batch ``cols`` (its
        ``BatchColumns``). A chimera round passes the removed peaks, its
        report depth and its recomputed TICs."""
        with trace.span("search.dispatch", batch):
            d2 = self._stage2_dispatch(prelim, cols.intens, peaks_dev,
                                       masses=cols.masses,
                                       removed_masks=removed_masks)
        if report_psms is None:
            report_psms = self.params.report_psms
        with trace.span("search.finalize", batch):
            return self._stage2_finalize(cols, prelim, d2, report_psms,
                                         tic_override=tic_override)

    def _stage2_dispatch(self, prelim, intens, peaks_dev, masses=None,
                         removed_masks=None):
        """Launch the full rescore of every merged candidate: one item
        per (spectrum, peptide, charge). With ``removed_masks`` (a chimera
        round) the removed peaks get intensity -1 and the packed peaks are
        uploaded again, to this Scorer's device."""
        p = self.params
        spec_i = prelim["cand_spec"]
        nI = spec_i.shape[0]
        if removed_masks is not None:
            intens = np.where(removed_masks, -1.0, intens).astype(np.float32)
        if nI == 0:
            return {"out_dev": None, "nI": 0, "use_int": intens}
        if removed_masks is not None:
            peaks_dev = self._peaks_device(masses, intens)
        chg = prelim["cand_charge"]
        ints = np.zeros((3, nI), np.int32)  # spectrum, peptide, maxz
        ints[0] = spec_i
        ints[1] = prelim["cand_pep"]
        cap = (
            np.minimum(chg, p.max_fragment_charge + 1)
            if p.max_fragment_charge is not None
            else chg
        )
        ints[2] = np.minimum(np.maximum(cap, 2), self.Z + 1)
        Zb = min(max(int(ints[2].max()) - 1, 1), self.Z)
        return {"out_dev": self._stage2_rescore(
            peaks_dev, _to_dev(ints, self.device), Zb), "nI": nI,
            "use_int": intens}

    def _stage2_rescore(self, peaks_dev, ints, Zb):
        """``rescore_indexed`` for the items ``ints`` [3, N] (spectrum,
        peptide, exclusive fragment-charge bound), one candidate each:
        f32 [N, 7] (mb, my, summed_b, summed_y, ppm_sum, longest_b,
        longest_y): one item a row (k = 1), reading its ladder row and its
        spectrum's peak row by index."""
        mb, my, sb, sy, pp, lb, ly = rescore_indexed(
            self.tables.lad_full, ints[1][:, None], ints[0], peaks_dev[0],
            peaks_dev[1], ints[2][:, None],
            series=self.series, frag_tol=_tol_tuple(self.params.fragment_tol),
            Z=Zb,
        )
        f32 = torch.float32
        return torch.stack(
            [mb.to(f32), my.to(f32), sb, sy, pp, lb.to(f32), ly.to(f32)],
            dim=-1,
        )[:, 0]

    def _stage2_finalize(self, cols, prelim, d2, report_psms,
                         tic_override=None) -> FeatureTable:
        """Exact f64 hyperscores of the rescored items, the per-spectrum
        ranking by (hyperscore desc, merge order), and the reported
        rows' columns (``cols``: the batch's ``BatchColumns``)."""
        p = self.params
        spec_i = prelim["cand_spec"]
        pep_i = prelim["cand_pep"]
        chg = prelim["cand_charge"]
        iso = prelim["cand_iso"]
        nI = d2["nI"]
        spec_ids = list(cols.ids)
        if nI == 0:
            t = FeatureTable.empty()
            t.spec_ids = spec_ids
            return t
        with trace.span("search.fetch"):
            out = d2["out_dev"].cpu().numpy()  # f32 [nI, 7]
        mb = out[:nI, 0].astype(np.int32)
        my = out[:nI, 1].astype(np.int32)
        sb, sy, ppm_sum = out[:nI, 2], out[:nI, 3], out[:nI, 4]
        lb = out[:nI, 5].astype(np.int32)
        ly = out[:nI, 6].astype(np.int32)

        # vectorized exact feature math
        hs = hyperscore_vec(p.score_type, mb, my, sb, sy)
        ssum = (sb + sy).astype(np.float32)
        ppm = np.where(
            ssum != 0, ppm_sum / np.where(ssum == 0, np.float32(1.0), ssum), 0.0
        ).astype(np.float32)
        ok = (mb + my) >= p.min_matched_peaks
        if not ok.any():
            t = FeatureTable.empty()
            t.spec_ids = spec_ids
            return t

        # group candidates by spectrum (the arrays are spectrum-ascending)
        # and stable-sort each group by hyperscore desc (scoring.rs:495)
        idx_all = np.flatnonzero(ok)
        order = np.lexsort((-hs[idx_all], spec_i[idx_all]))
        items = idx_all[order]
        s_srt = spec_i[items]
        hs_srt = hs[items]
        starts = np.r_[0, np.flatnonzero(np.diff(s_srt)) + 1]
        counts = np.diff(np.r_[starts, s_srt.size])
        group_start = np.repeat(starts, counts)
        rank = np.arange(s_srt.size) - group_start

        # delta_next vs the next candidate of the same group (0 past the
        # end); delta_best vs the group's best
        nxt = np.r_[hs_srt[1:], 0.0]
        same = np.r_[s_srt[1:] == s_srt[:-1], False]
        delta_next = hs_srt - np.where(same, nxt, 0.0)
        delta_best = hs_srt[group_start] - hs_srt

        rep = rank < report_psms
        ri = items[rep]  # original candidate indices of reported PSMs

        return self._emit_table(
            cols,
            s_of=spec_i[ri], pep=pep_i[ri], z_of=chg[ri], iso_i=iso[ri],
            mb=mb[ri], my=my[ri], sb=sb[ri], sy=sy[ri], ppm=ppm[ri],
            lb=lb[ri], ly=ly[ri], hs=hs[ri], rank0=rank[rep],
            delta_next=delta_next[rep], delta_best=delta_best[rep],
            spec_matched=prelim["spec_matched"],
            spec_scored=prelim["spec_scored"],
            tic_override=tic_override, use_int=d2["use_int"],
        )

    def _row_buckets(self, rows, n_rows, W):
        """Split query rows into up to 4 quarter-octave window-width
        classes x up to 3 ladder-length classes (each row lands in the
        smallest class covering its precursor window and the longest
        peptide inside it). Returns [(Wb, Lcb, row_indices)]
        largest-W-first, or None when a single class is as good (few
        rows, narrow max width).

        The split is 2D because width and length ANTI-correlate: ppm
        windows narrow toward the mass extremes, so the narrow-width
        class mixes the lightest (shortest) and heaviest (longest)
        peptides — a per-width Lc max would recover nothing."""
        if n_rows < 256 or W < 64:
            return None
        widths = (rows["i1"] - rows["i0"]).astype(np.int64)
        # width levels from the batch's REAL max width (not its pow2
        # ceiling W) on a quarter-octave grid, stepping down by ~1/1.5
        levels = [_quarter_octave(int(widths.max(initial=8)))]
        while len(levels) < 4:
            nxt = _quarter_octave(max(levels[-1] * 2 // 3, 8))
            if nxt >= levels[-1]:
                nxt = levels[-1] // 2
            if nxt < 16:
                break
            levels.append(nxt)
        lv = np.asarray(sorted(set(levels)), np.int64)     # ascending
        assign = np.searchsorted(lv, widths, side="left")  # smallest fit
        counts = np.bincount(assign, minlength=lv.size)
        # fold sparse classes upward: a class must hold >= 10% of rows
        # (and >= 64 rows) to pay for its extra segment
        floor = max(64, n_rows // 10)
        for i in range(lv.size - 1):
            if 0 < counts[i] < floor:
                assign[assign == i] = i + 1
                counts[i + 1] += counts[i]
                counts[i] = 0
        live = [i for i in range(lv.size) if counts[i] > 0]
        L = self.tables.L
        if len(live) < 2 and L <= _LC_GRID[0]:
            return None

        # Length classes within each width class, from the fixed grid so
        # segment shapes stay stable across batches.
        lneed = _window_lneed(
            self.db.table.lens, rows["i0"], rows["i1"],
            blkmax=self._lens_blk(),
        )
        out = []
        for i in sorted(live, reverse=True):
            idx = np.flatnonzero(assign == i)
            lcs = np.asarray(
                [_lc_class(int(v), L) for v in lneed[idx]], np.int64
            )
            grid = sorted({int(v) for v in lcs})
            cnt = {g: int((lcs == g).sum()) for g in grid}
            # fold sparse length classes upward (same floor rule), then
            # cap at 3 classes per width bucket by folding the smallest
            lfloor = max(64, idx.size // 10)
            for j, g in enumerate(grid[:-1]):
                if 0 < cnt[g] < lfloor:
                    nxt = grid[j + 1]
                    lcs[lcs == g] = nxt
                    cnt[nxt] += cnt[g]
                    cnt[g] = 0
            livel = [g for g in grid if cnt[g] > 0]
            while len(livel) > 3:
                # fold the least-populated class into the next above
                j = min(range(len(livel) - 1), key=lambda k: cnt[livel[k]])
                g, nxt = livel[j], livel[j + 1]
                lcs[lcs == g] = nxt
                cnt[nxt] += cnt[g]
                livel.pop(j)
            for g in sorted(livel, reverse=True):
                out.append((int(lv[i]), int(g), idx[lcs == g]))
        if len(out) < 2:
            return None
        return out

    def _emit_table(
        self, cols, *, s_of, pep, z_of, iso_i, mb, my, sb, sy, ppm,
        lb, ly, hs, rank0, delta_next, delta_best, spec_matched,
        spec_scored, tic_override, use_int=None,
    ) -> FeatureTable:
        """Column assembly for the REPORTED rows (scoring.rs:478-595's
        Feature construction): every per-row argument is already
        restricted to reported PSMs in final (spectrum asc, rank asc)
        order; per-spectrum statistics arrive as full [n_spec] arrays.
        The per-spectrum metadata comes from ``cols`` (the batch's
        ``BatchColumns``); the annotations read its padded masses and the
        intensities ``use_int``, its own where None (a chimera round's
        have its removed peaks at -1)."""
        p = self.params
        n_rep = s_of.size
        spec_ids = list(cols.ids)

        # Per-spectrum metadata columns
        sp_rt = cols.rt
        sp_tic = cols.tic
        sp_mz = (cols.prec_mz - PROTON).astype(np.float32)
        sp_ims = cols.ims
        sp_file = cols.file_id
        if tic_override is not None:
            sp_tic = np.asarray(tic_override, np.float32)

        tbl = self.db.table
        pm = (sp_mz[s_of] * z_of.astype(np.float32)).astype(np.float32)
        calc = tbl.mono[pep]
        iso_err = (iso_i.astype(np.float32) * NEUTRON).astype(np.float32)
        with np.errstate(divide="ignore", invalid="ignore"):
            delta_mass = (
                (((pm - calc).astype(np.float32) - iso_err).astype(np.float32)
                 * np.float32(2e6)).astype(np.float32)
                / ((pm - iso_err).astype(np.float32) + calc).astype(np.float32)
            ).astype(np.float32)
        k_match = (mb + my).astype(np.int32)
        scored_cand = spec_scored[s_of].astype(np.int32)
        with np.errstate(divide="ignore", invalid="ignore"):
            lam = np.where(
                spec_scored > 0,
                spec_matched / np.maximum(spec_scored, 1),
                0.0,
            )
        poisson = log10_poisson_vec(lam[s_of], k_match)
        msum = (sb + sy).astype(np.float32)
        tic_col = sp_tic[s_of]
        plen = tbl.lens[pep].astype(np.int32)

        t = FeatureTable.empty(n_rep)
        c = t.columns
        c["peptide_idx"][:] = pep
        c["psm_id"][:] = np.arange(
            self._psm_counter, self._psm_counter + n_rep, dtype=np.int64
        )
        self._psm_counter += n_rep
        c["peptide_len"][:] = plen
        c["spec_idx"][:] = s_of
        c["file_id"][:] = sp_file[s_of]
        c["rank"][:] = rank0 + 1
        c["label"][:] = np.where(tbl.decoy[pep], -1, 1)
        c["expmass"][:] = pm
        c["calcmass"][:] = calc
        c["charge"][:] = z_of
        c["rt"][:] = sp_rt[s_of]
        c["aligned_rt"][:] = sp_rt[s_of]
        c["ims"][:] = sp_ims[s_of]
        c["delta_mass"][:] = delta_mass
        c["isotope_error"][:] = iso_err
        c["average_ppm"][:] = ppm
        c["hyperscore"][:] = hs
        c["delta_next"][:] = delta_next
        c["delta_best"][:] = delta_best
        c["matched_peaks"][:] = k_match
        c["longest_b"][:] = lb
        c["longest_y"][:] = ly
        c["longest_y_pct"][:] = (
            ly.astype(np.float32) / plen.astype(np.float32)
        ).astype(np.float32)
        c["missed_cleavages"][:] = tbl.missed_cleavages[pep]
        with np.errstate(divide="ignore", invalid="ignore"):
            c["matched_intensity_pct"][:] = (
                (np.float32(100.0) * msum).astype(np.float32) / tic_col
            ).astype(np.float32)
        c["scored_candidates"][:] = scored_cand
        c["poisson"][:] = poisson
        c["ms2_intensity"][:] = msum
        t.spec_ids = spec_ids

        if p.annotate_matches:
            masses, Pk = cols.masses, cols.Pk
            if use_int is None:
                use_int = cols.intens
            t.fragments = [
                self._annotate_item(
                    int(pep[i]), int(z_of[i]), int(s_of[i]), masses,
                    use_int, Pk
                )
                for i in range(n_rep)
            ]
        return t

    def _annotate_item(self, pep_i, charge, si, masses, intens, Pk):
        """Matched-fragment annotations for one reported PSM
        (scoring.rs:738-751) — recomputed on host with the exact scalar
        peak-selection semantics; only runs for reported PSMs."""
        from ..spectrum.processor import select_most_intense_peak

        db = self.db
        peptide = db.peptides[pep_i]
        n_ions = len(peptide.sequence) - 1
        lad = _host_ladders(db, [pep_i], self.series)
        mzmax = max_fragment_charge(self.params.max_fragment_charge, charge)
        frags = Fragments()
        sm = masses[si]
        sv = intens[si]
        for s, kind in enumerate(self.series):
            for l in range(n_ions):
                for z in range(1, mzmax):
                    center = F32(lad[0, s, l] / F32(z))
                    # select_most_intense_peak starts its running max at 0,
                    # so removed peaks (intensity -1) can never be chosen —
                    # matching the device's `pki >= 0` qualifier.
                    pk = select_most_intense_peak(
                        sm, sv, center, self.params.fragment_tol
                    )
                    if pk is None:
                        continue
                    calc_mz = F32(center + PROTON)
                    exp_mz = F32(sm[pk] + PROTON)
                    ordinal = l + 1 if _SERIES_NTERM[kind] else n_ions - l
                    frags.kinds.append(kind)
                    frags.charges.append(z)
                    frags.mz_calculated.append(float(calc_mz))
                    frags.mz_experimental.append(float(exp_mz))
                    frags.fragment_ordinals.append(int(ordinal))
                    frags.intensities.append(float(sv[pk]))
        return frags

    # ------------------------------------------------------------------
    # Chimeric search (scoring.rs:598-672)
    # ------------------------------------------------------------------

    def _score_chimera(self, spectra) -> FeatureTable:
        """Stage 1 once, then rounds of the full rescore, each on the
        peaks that the earlier rounds' PSMs left (``chimera_rounds``)."""
        cols = BatchColumns(spectra)
        masses, intens = cols.masses, cols.intens
        prelim = self._preliminary(
            spectra, masses=masses,
            peaks_dev=self._peaks_device(masses, intens),
        )

        def features_table(removed, tic):
            return self._features_table(
                cols, prelim, None, report_psms=1, removed_masks=removed,
                tic_override=tic,
            )

        return chimera_rounds(self, spectra, masses, intens, features_table)

    def _remove_matched(self, si, pep_i, charge, masses, intens, removed):
        """scoring.rs:598-644: mark the peaks that the PSM's complete
        theoretical ladder (all fragment charges) matches as removed."""
        from ..spectrum.processor import select_most_intense_peak

        db = self.db
        b_host = _host_ladders(db, [pep_i], self.series)
        n_ions = len(db.peptides[pep_i].sequence) - 1
        mzmax = max_fragment_charge(self.params.max_fragment_charge, charge)
        valid = np.isfinite(masses[si]) & ~removed[si]
        vm = masses[si][valid]
        vi = intens[si][valid]
        vidx = np.nonzero(valid)[0]
        to_remove = set()
        for s in range(self.n_series):
            for l in range(n_ions):
                for z in range(1, mzmax):
                    center = F32(b_host[0, s, l] / F32(z))
                    j = select_most_intense_peak(vm, vi, center,
                                                 self.params.fragment_tol)
                    if j is not None:
                        to_remove.add((float(vm[j]), float(vi[j])))
        for j0, gi in enumerate(vidx):
            if (float(vm[j0]), float(vi[j0])) in to_remove:
                removed[si][gi] = True


def chimera_rounds(host, spectra, masses, intens, features_table):
    """The chimera round loop (scoring.rs:598-672). ``features_table(removed,
    tic)`` returns one round's FeatureTable; ``host`` supplies the
    parameters and the exact host-side peak removal (``_remove_matched``).
    Each round keeps the best new PSM of every spectrum still active,
    removes its matched peaks, recomputes the spectrum's TIC with the
    reference's sequential f32 sum, and runs again until report_psms
    rounds or a round that finds no new PSM."""
    from ..native import seq_f32_sum_rows

    p = host.params
    removed = np.zeros_like(intens, dtype=bool)
    tic = np.array([s.total_ion_current for s in spectra], dtype=np.float32)
    rounds: List[FeatureTable] = []
    n_hits = np.zeros(len(spectra), dtype=np.int32)
    active = set(range(len(spectra)))
    for _ in range(p.report_psms):
        if not active:
            break
        t = features_table(removed, tic)
        keep_rows = []
        newly = set()
        for i in range(len(t)):
            si = int(t.columns["spec_idx"][i])
            if si not in active:
                continue
            keep_rows.append(i)
            n_hits[si] += 1
            t.columns["rank"][i] = n_hits[si]
            newly.add(si)
            host._remove_matched(
                si, int(t.columns["peptide_idx"][i]),
                int(t.columns["charge"][i]), masses, intens, removed,
            )
            tic[si] = seq_f32_sum_rows(
                np.where(
                    removed[si], 0.0,
                    np.where(np.isfinite(masses[si]), intens[si], 0.0),
                )[None, :],
                np.array([intens.shape[1]], dtype=np.int32),
            )[0]
        if not keep_rows:
            break
        rounds.append(t.select(np.asarray(keep_rows, dtype=np.int64)))
        active = {si for si in newly if n_hits[si] < p.report_psms}
    if not rounds:
        out = FeatureTable.empty()
        out.spec_ids = [s.id for s in spectra]
        return out
    # every round shares the batch's spec_ids; concat would re-base
    # spec_idx, so the rounds are merged by hand
    merged = FeatureTable.empty(sum(len(t) for t in rounds))
    off = 0
    for t in rounds:
        n = len(t)
        for k in merged.columns:
            merged.columns[k][off : off + n] = t.columns[k]
        merged.protein_groups[off : off + n] = t.protein_groups
        merged.fragments[off : off + n] = t.fragments
        off += n
    merged.spec_ids = rounds[0].spec_ids
    return merged


def _fill_rows(ints, sl, rows, idx, maxz, slot_vals):
    """Fill the merge's row-table columns (spectrum, i0, i1, maxz, z, iso,
    slot) of the [8, R] i32 ``ints`` at ``sl`` from query rows ``idx``;
    ``slot_vals`` are the rows' merge-grid slots."""
    ints[0, sl] = rows["si"][idx]
    ints[2, sl] = rows["i0"][idx]
    ints[3, sl] = rows["i1"][idx]
    ints[4, sl] = maxz[idx]
    ints[5, sl] = rows["z"][idx]
    ints[6, sl] = rows["iso"][idx]
    ints[7, sl] = slot_vals


def _open_ints(R_b, S_pad, rows, idx, maxz, slot_vals):
    """The [8, R_b] row table of one open pseudo-segment; padding rows
    carry the spectrum sentinel S_pad."""
    ints = np.zeros((8, R_b), dtype=np.int32)
    ints[0] = S_pad
    ints[4] = 2
    _fill_rows(ints, slice(0, idx.size), rows, idx, maxz, slot_vals)
    return ints


def _host_ladders(db: IndexedDatabase, pep_indices, series) -> np.ndarray:
    """Exact host-side ion ladders for the given peptides: [n, n_series,
    L] neutral masses."""
    from ..native import seq_f32_cumsum_rows

    t = db.table
    idx = np.asarray(pep_indices, dtype=np.int64)
    res = t.resmass[idx]
    ntm = t.nterm[idx]
    mono = t.mono[idx]
    lens = np.maximum(t.lens[idx] - 1, 0).astype(np.int32)
    out = []
    for kind in series:
        seed = _SERIES_SEED[kind]
        if _SERIES_NTERM[kind]:
            init = (ntm + seed).astype(np.float32)
            lad = seq_f32_cumsum_rows(res, init, lens)
        else:
            init = ((mono - ntm) + seed).astype(np.float32)
            lad = seq_f32_cumsum_rows(-res, init, lens)
        out.append(lad)
    return np.stack(out, axis=1)
