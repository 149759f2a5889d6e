"""The candidate rescore: the CUDA kernel's wrapper and its plain
PyTorch version.

Counterpart of ``sage_tpu/ops/search.py:285 rescore_candidate``, which
XLA fuses into the jitted stage-2 programs (no Pallas kernel). For each
live item (a candidate peptide's full fragment ladders against its
spectrum's peaks) and each (series, ion, fragment charge) slot: the most
intense in-window peak (ties to the greater mass), then the matched
counts per terminus, the strictly sequential f32 intensity and ppm sums
in the fragments-iterator order, and the longest-run automata
(scoring.rs:675-793).

:func:`rescore_indexed` reads the ladder table, the items' peptides and
their rows' peaks by index; :func:`rescore_candidate` is its thin form
over an explicit ladder grid. A CUDA tensor goes to the kernel
(``csrc/rescore.cu``), a CPU tensor to the plain version. ``launches``
counts kernel launches, as does the recorder's ``launch.rescore``
counter (``utils/trace.py``). The module also holds the f32 helpers that
``ops/search.py`` imports from it: ``_fdiv``, ``tol_bounds_static`` and
``_SERIES_NTERM``.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from .pallas_stage1 import _TOL_KIND
from ..utils import trace

launches = 0

# Items of the [items, S, L, Pk] rescore compare grid per chunk of the
# plain version.
_RESCORE_CHUNK = 1 << 26

_SERIES_NTERM = {"a": True, "b": True, "c": True,
                 "x": False, "y": False, "z": False}

# warps a block of the kernel (csrc/rescore.cu's kWarps)
_WARPS = 8
_SMEM_MAX = 227 * 1024


def _fdiv(x: torch.Tensor, s) -> torch.Tensor:
    """``x / s`` rounded as one IEEE f32 division on every device: the
    divisor is a tensor of x's shape, never a host scalar (CUDA computes
    a tensor divided by a host scalar as a multiply by its reciprocal)."""
    return x / torch.full_like(x, float(s))


def tol_bounds_static(kind: str, lo: float, hi: float, center):
    """Tolerance.bounds as f32 tensor ops with the reference's op order
    (mass.rs:21-35): ``c + (c * lo) / s`` for ppm (s = 1e6) and pct
    (s = 100), ``c + lo`` for da. The CUDA kernel computes the same
    expression with the same rounding."""
    lo = float(np.float32(lo))
    hi = float(np.float32(hi))
    if kind in ("ppm", "pct"):
        s = 1e6 if kind == "ppm" else 100.0
        return (center + _fdiv(center * lo, s),
                center + _fdiv(center * hi, s))
    return center + lo, center + hi


def rescore_smem_bytes(S: int, L: int) -> int:
    """Dynamic shared memory a block of the kernel needs, in bytes (the
    mirror of ``csrc/rescore.cu:rescore_smem_bytes``): a 16-bit slot index
    a ladder slot for each of its 8 warps. Only the ladder's S x L enters:
    no peak count and no item count bounds it."""
    return _WARPS * ((2 * S * L + 15) // 16 * 16)


def _bind():
    from ._cuda_build import load

    lib = load("rescore")
    fn = lib.rescore_indexed
    if fn.argtypes is None:
        c_int, c_ptr = ctypes.c_int, ctypes.c_void_p
        fn.argtypes = (
            [c_ptr] * 7 + [c_int] * 10 + [ctypes.c_float] * 2 + [c_ptr] * 8
        )
        fn.restype = c_int
        lib.rescore_smem_bytes.argtypes = [c_int] * 2
        lib.rescore_smem_bytes.restype = ctypes.c_longlong
    return lib


def rescore_indexed(lad, pep, spec, pkm, pki, maxz, live=None, *, series,
                    frag_tol, Z):
    """The full score_candidate computation (scoring.rs:675-767) for a
    grid of items read by index; see :func:`rescore_indexed_plain` for
    the arguments and outputs. A CUDA tensor launches ``csrc/rescore.cu``
    (nothing when ``n * k == 0``), a CPU tensor takes the plain version,
    any other device raises.

    Precondition, not checked here (that would need a device
    synchronise; the tests check it at every caller): every peak row that
    a live item reads ascends in mass, holds no NaN mass and has its
    ``+inf`` pads last, as ``spectrum/processor.py`` sorts the peaks and
    ``Scorer._pad_peaks`` pads them. The kernel finds each slot's
    qualifying peaks by binary search over the row."""
    global launches
    if lad.device.type == "cpu":
        return rescore_indexed_plain(lad, pep, spec, pkm, pki, maxz, live,
                                     series=series, frag_tol=frag_tol, Z=Z)
    if lad.device.type != "cuda":
        raise ValueError(f"rescore_indexed: unsupported device {lad.device}")
    kind, tlo, thi = frag_tol
    ts = (lad, pep, spec, pkm, pki, maxz) + (() if live is None else (live,))
    checks = (
        (lad.dim() == 3 and pep.dim() == 2 and spec.dim() == 1
         and pkm.dim() == 2 and pki.dim() == 2 and maxz.dim() == 2
         and (live is None or live.dim() == 1),
         "lad must be [P, S, L], pep / maxz [n, k], spec / live [n], "
         "pkm / pki [B, Pk]"),
        (lad.dtype == pkm.dtype == pki.dtype == torch.float32
         and all(t.dtype == torch.int32
                 for t in (pep, spec, maxz) + ts[6:]),
         "dtypes must be f32 (lad, pkm, pki) and i32 (pep, spec, maxz, "
         "live)"),
        (all(t.device == lad.device for t in ts),
         "tensors must share one device"),
        (all(t.is_contiguous() for t in ts), "tensors must be contiguous"),
    )
    for ok, msg in checks:
        if not ok:
            raise ValueError(f"rescore_indexed: {msg}")
    P, S, L = lad.shape
    n, k = pep.shape
    B, Pk = pkm.shape
    checks = (
        (pkm.shape == pki.shape and tuple(maxz.shape) == (n, k)
         and spec.shape[0] == n and (live is None or live.shape[0] == n),
         f"shapes pep {tuple(pep.shape)}, spec {tuple(spec.shape)}, maxz "
         f"{tuple(maxz.shape)}, pkm {tuple(pkm.shape)}, pki "
         f"{tuple(pki.shape)} disagree"),
        (len(series) == S and 1 <= S <= 32, f"series {series} for S={S}"),
        (L >= 1 and Z >= 1 and S * L <= 65536,
         f"bad shapes S={S} L={L} Z={Z}"),
        (n * k == 0 or min(P, B, Pk) >= 1,
         f"empty tables P={P} B={B} Pk={Pk}"),
        (kind in _TOL_KIND, f"tolerance kind {kind!r}"),
    )
    for ok, msg in checks:
        if not ok:
            raise ValueError(f"rescore_indexed: {msg}")
    outs = [torch.empty((n, k), dtype=dt, device=lad.device)
            for dt in (torch.int32, torch.int32, torch.float32, torch.float32,
                       torch.float32, torch.int32, torch.int32)]
    if n * k == 0:
        return tuple(outs)
    smem = rescore_smem_bytes(S, L)
    if smem > _SMEM_MAX:
        raise ValueError(
            f"rescore_indexed: {smem} B of shared memory (S={S}, L={L}) "
            f"exceeds the 227 KB a block can use")
    lib = _bind()
    nterm = sum(1 << i for i, s in enumerate(series) if _SERIES_NTERM[s])
    with torch.cuda.device(lad.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.rescore_indexed(
            lad.data_ptr(), pep.data_ptr(), spec.data_ptr(), pkm.data_ptr(),
            pki.data_ptr(), maxz.data_ptr(),
            None if live is None else live.data_ptr(),
            n, k, P, B, S, L, Pk, Z, nterm, _TOL_KIND[kind],
            float(np.float32(tlo)), float(np.float32(thi)),
            *(o.data_ptr() for o in outs), stream,
        )
    if rc != 0:
        raise RuntimeError(f"rescore_indexed launch failed: CUDA error {rc}")
    launches += 1
    trace.count("launch.rescore")
    return tuple(outs)


def _dense_form(f):
    """An explicit ladder grid ``f`` [n, k, S, L] as the indexed form's
    table and indices: lad [n * k, S, L], pep = arange [n, k] and
    spec = arange [n]."""
    n, k, S, L = f.shape
    dev = f.device
    return (f.contiguous().reshape(n * k, S, L),
            torch.arange(n * k, dtype=torch.int32, device=dev).reshape(n, k),
            torch.arange(n, dtype=torch.int32, device=dev))


def rescore_candidate(f, pkm, pki, maxz, *, series, frag_tol, Z):
    """:func:`rescore_indexed` over an explicit ladder grid ``f``
    [n, k, S, L] against the peaks ``pkm`` / ``pki`` [n, Pk] of each
    row, every item live."""
    lad, pep, spec = _dense_form(f)
    return rescore_indexed(lad, pep, spec, pkm, pki, maxz, None,
                           series=series, frag_tol=frag_tol, Z=Z)


def rescore_candidate_plain(f, pkm, pki, maxz, *, series, frag_tol, Z):
    """The plain version of :func:`rescore_candidate`."""
    lad, pep, spec = _dense_form(f)
    return rescore_indexed_plain(lad, pep, spec, pkm, pki, maxz, None,
                                 series=series, frag_tol=frag_tol, Z=Z)


def _rescore_match(f, pkm, pki, maxz, frag_tol, Z):
    """Per-(fragment, charge) most intense in-window peak for items
    ``f`` [n, k, S, L] against their spectrum's peaks ``pkm``/``pki``
    [n, Pk]: returns (matched bool, intensity, mass), each
    [n, k, S, L, Z]."""
    kind, tlo, thi = frag_tol
    neg_inf = torch.tensor(-np.inf, dtype=torch.float32, device=f.device)
    minus1 = torch.tensor(-1.0, dtype=torch.float32, device=f.device)
    pm = pkm[:, None, None, None, :]
    pi = pki[:, None, None, None, :]
    live_pk = pi >= 0
    matched, best_i, best_m = [], [], []
    for zi in range(Z):
        mzc = _fdiv(f, zi + 1)
        lo, hi = tol_bounds_static(kind, tlo, thi, mzc)
        z_ok = ((zi + 1) < maxz)[:, :, None, None, None]
        qual = (pm >= lo[..., None]) & (pm <= hi[..., None]) & live_pk & z_ok
        val = torch.where(qual, pi, minus1)
        # Most intense in-window peak: a plain max gives the intensity;
        # the matched peak's mass is the max mass among peaks attaining
        # it — masses ascend with index, so this reproduces the
        # ties-to-the-LATER-index rule (spectrum.rs:150-157).
        best = val.amax(dim=-1)
        bmass = torch.where(val == best[..., None], pm, neg_inf).amax(dim=-1)
        m = best >= 0
        matched.append(m)
        best_i.append(torch.where(m, best, 0.0))
        best_m.append(torch.where(m, bmass, 0.0))
    return (torch.stack(matched, -1), torch.stack(best_i, -1),
            torch.stack(best_m, -1))


def rescore_indexed_plain(lad, pep, spec, pkm, pki, maxz, live=None, *,
                          series, frag_tol, Z):
    """The full score_candidate computation (scoring.rs:675-767) for a
    grid of items read by index: per-(fragment, charge) most-intense-peak
    match, strictly sequential f32 intensity/ppm accumulation in the
    reference's fragments-iterator order (series, ion, charge), matched
    counts and longest-run automata.

    lad: [P, S, L] neutral ladders (invalid slots -inf); pep: [n, k] i32
    item (r, j)'s row of ``lad``; spec: [n] i32 row r's row of the peaks;
    pkm/pki: [B, Pk] peak masses/intensities; maxz: [n, k] i32 exclusive
    fragment-charge bounds; live: [n] i32, items [0, live[r]) of row r
    are live, or None (all live); frag_tol: (kind, lo, hi). An index out
    of its table's range reads the nearest row, as a clamped gather does.
    Returns (mb, my, summed_b, summed_y, ppm_sum, longest_b, longest_y),
    each [n, k], 0 at the dead items. The [n, k, S, L, Pk] compare grid
    is built a chunk of rows at a time."""
    n, k = pep.shape
    P, n_series, L = lad.shape
    B, Pk = pkm.shape
    dev = lad.device
    if n * k == 0:
        return tuple(
            torch.zeros((n, k), dtype=dt, device=dev)
            for dt in (torch.int32, torch.int32, torch.float32, torch.float32,
                       torch.float32, torch.int32, torch.int32))
    f = lad[pep.long().clamp(0, P - 1)]  # [n, k, S, L]
    rows = spec.long().clamp(0, B - 1)
    is_nterm = torch.tensor([_SERIES_NTERM[s] for s in series],
                            dtype=torch.bool, device=dev)
    matched = torch.empty((n, k, n_series, L, Z), dtype=torch.bool,
                          device=dev)
    pk_i = torch.empty((n, k, n_series, L, Z), dtype=torch.float32,
                       device=dev)
    pk_m = torch.empty_like(pk_i)
    step = max(1, _RESCORE_CHUNK // max(k * n_series * L * Pk, 1))
    for a in range(0, n, step):
        b = min(a + step, n)
        matched[a:b], pk_i[a:b], pk_m[a:b] = _rescore_match(
            f[a:b], pkm[rows[a:b]], pki[rows[a:b]], maxz[a:b], frag_tol, Z
        )
    mz_c = torch.stack([_fdiv(f, zi + 1) for zi in range(Z)], dim=-1)

    # Per-fragment ppm term, f32 in the reference op order
    # (scoring.rs:719-720).
    d = (mz_c - pk_m).abs()
    denom = mz_c + pk_m
    one = torch.ones((), dtype=torch.float32, device=dev)
    ppm_t = torch.where(
        matched,
        ((pk_i * d) * 2e6) / torch.where(denom == 0, one, denom),
        0.0,
    )

    bm3 = is_nterm[:, None, None]  # [S, 1, 1]
    mb = (matched & bm3).sum(dim=(2, 3, 4), dtype=torch.int32)
    my = (matched & ~bm3).sum(dim=(2, 3, 4), dtype=torch.int32)

    # Strictly sequential f32 sums in fragments-iterator order (series,
    # ion, charge): one eager add per term, never a tree reduction.
    # Adding 0.0f is exact, so unmatched slots can stay in the chain.
    T = n_series * L * Z
    terms = torch.stack(
        [torch.where(bm3, pk_i, 0.0).reshape(n, k, T),
         torch.where(~bm3, pk_i, 0.0).reshape(n, k, T),
         ppm_t.reshape(n, k, T)],
        dim=-1,
    )  # [n, k, T, 3]
    sums = torch.zeros((n, k, 3), dtype=torch.float32, device=dev)
    for i in range(T):
        sums = sums + terms[:, :, i]

    # Longest-run automata (scoring.rs:771-793) — all N-term series feed
    # one run in series order, all C-term series the other.
    m_any = matched.any(dim=-1)  # [n, k, S, L]
    ion_idx = torch.arange(L, dtype=torch.int32, device=dev)
    runs = []
    for term in (True, False):
        sel = [i for i, s in enumerate(series) if _SERIES_NTERM[s] == term]
        if len(sel) == 1:
            runs.append(longest_run_vec(m_any[:, :, sel[0]], ion_idx))
        elif sel:
            flags = m_any[:, :, sel].reshape(n, k, len(sel) * L)
            runs.append(longest_run_scan(flags, ion_idx.repeat(len(sel))))
        else:
            runs.append(torch.zeros((n, k), dtype=torch.int32, device=dev))
    outs = (mb, my, sums[..., 0], sums[..., 1], sums[..., 2], runs[0],
            runs[1])
    if live is None:
        return outs
    dead = (torch.arange(k, device=dev)[None, :]
            >= live.to(dev).long()[:, None])
    return tuple(o.masked_fill(dead, 0) for o in outs)


def longest_run_scan(flags, idx):
    """The reference's Run automaton verbatim (scoring.rs:771-793) as a
    sequential loop over (matched, ion_index) pairs along the last axis
    of ``flags`` [..., T] (``idx`` [T] i32) — the general form that
    handles several series feeding one terminus's Run."""
    shape = flags.shape[:-1]
    zero = torch.zeros(shape, dtype=torch.int32, device=flags.device)
    start, length, last, longest = zero, zero, zero, zero
    one = torch.ones((), dtype=torch.int32, device=flags.device)
    for t in range(flags.shape[-1]):
        m = flags[..., t]
        l = idx[t]
        skip = m & (last == l)
        extend = m & ~skip & (start + length == l)
        restart = m & ~skip & ~extend
        length = torch.where(extend, length + 1, torch.where(restart, one, length))
        start = torch.where(restart, l, start)
        longest = torch.where(extend | restart, torch.maximum(longest, length),
                              longest)
        last = torch.where(m & ~skip, l, last)
    return longest


def longest_run_vec(flags, ion_idx):
    """Single-series terminus: the Run automaton reduces to "longest run
    of consecutive matched ion indices with index 0 swallowed" (``last``
    inits to 0, so the first visit of l=0 always takes the skip branch).
    Exactly computable with an integer cumulative max along the last
    axis: run_len[l] = l - (last unmatched index <= l)."""
    m1 = flags & (ion_idx > 0)
    nf = torch.where(m1, torch.full_like(ion_idx, -1), ion_idx)
    prev_nf = torch.cummax(nf, dim=-1).values
    return torch.where(m1, ion_idx - prev_nf, 0).amax(dim=-1).to(torch.int32)
