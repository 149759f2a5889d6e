"""Inputs and numpy models for the peak-major searches' three kernels:
the window-range search (``csrc/peak_ranges.cu``, open and banded
forms), the entry gather (``csrc/open_entries.cu``) and the run-count
top-K (``csrc/open_count.cu``).

Each model follows its kernel's algorithm step for step (the binary
searches, the scan and per-element window search, the warp-wide 32-probe
searches, the run walk and the threshold buffer of the top-K), so the
CPU tests can hold the algorithm against the plain versions that the
CPU runs, and the card tests can draw their inputs from the same
generators. No JAX here: the card's machine may not have it."""

import numpy as np
import torch

from _rescore_cases import bound_centres, ieee_bounds, on_bound_masses

F32 = np.float32
INT32_MAX = 2**31 - 1
PMAX = 1 << 25
NOPEP = 1 << 30


# ---- the window-range search ---------------------------------------------

def _centres(masses, zi):
    """m * (zi + 1) in f32, as the kernel computes it (m itself at zi = 0)."""
    m = np.asarray(masses, F32)
    with np.errstate(all="ignore"):
        return m if zi == 0 else m * F32(zi + 1)


def _rank(a, x, strict):
    """The kernel's binary search, vectorised: per value of ``x``, the count
    of the ascending ``a`` that are < x (strict) or <= x."""
    lo = np.zeros(x.shape, np.int64)
    ln = np.full(x.shape, a.size, np.int64)
    while (ln > 0).any():
        act = ln > 0
        half = ln >> 1
        v = (a[np.where(act, lo + half, 0)] if a.size
             else np.zeros(x.shape, F32))
        with np.errstate(invalid="ignore"):
            pred = (v < x) if strict else (v <= x)
        go = act & pred
        lo = np.where(go, lo + half + 1, lo)
        ln = np.where(go, ln - half - 1, np.where(act, half, ln))
    return lo


def model_open_ranges(tabs, masses, band, valid, *, nsub, Zb, tol,
                      spec=None):
    """peak_ranges_open: i32 [NS / nsub, Zb*nsub*Pk] starts and lengths."""
    mz64, _d, _d2, row_off, blen, boff, bfirst, blast = (
        np.asarray(t.cpu()) for t in tabs)
    flat = mz64.reshape(-1)
    masses = np.asarray(masses, F32)
    band = np.asarray(band, np.int64)
    valid = np.asarray(valid, bool)
    B, Pk = masses.shape
    NS, nb = band.size, blen.size
    st = np.zeros((NS // nsub, Zb * nsub * Pk), np.int32)
    ln = np.zeros_like(st)
    for s in range(NS):
        b = int(np.clip(band[s], 0, nb - 1))
        sp = int(np.clip(spec[s] if spec is not None else s // nsub, 0,
                         B - 1))
        a = flat[row_off[b] * 64: row_off[b] * 64 + blen[b]]
        for zi in range(Zb):
            lo, hi = ieee_bounds(tol, _centres(masses[sp], zi))
            with np.errstate(invalid="ignore"):
                hit = (valid[s] & np.isfinite(lo) & np.isfinite(hi)
                       & (hi >= bfirst[b]) & (lo <= blast[b]))
            r0 = _rank(a, np.where(hit, lo, 0), True)
            r1 = _rank(a, np.where(hit, hi, 0), False)
            col = (zi * nsub + s % nsub) * Pk + np.arange(Pk)
            st[s // nsub, col] = np.where(hit, boff[b] + r0, 0)
            ln[s // nsub, col] = np.where(hit, np.maximum(r1 - r0, 0), 0)
    return st, ln


def _bounded(mz, lo, hi, x, inclusive, nstep):
    lo = lo.astype(np.int64).copy()
    hi = hi.astype(np.int64).copy()
    n1 = mz.size - 1
    for _ in range(nstep):
        act = lo < hi
        if not act.any():
            break
        mid = (lo + hi) // 2
        v = mz[np.clip(mid, 0, n1)]
        with np.errstate(invalid="ignore"):
            pred = ((v <= x) if inclusive else (v < x)) & act
        lo = np.where(pred, mid + 1, lo)
        hi = np.where(act & ~pred, np.minimum(mid, hi), hi)
    return lo


def model_banded_ranges(frag_mz, masses, bb, *, Zb, tol, nstep):
    """peak_ranges_banded: i32 [B, Zb*nbcov*Pk] starts and lengths."""
    mz = np.asarray(frag_mz, F32)
    masses = np.asarray(masses, F32)
    bb = np.asarray(bb, np.int64)
    B, Pk = masses.shape
    nbcov = bb.shape[1]
    st = np.zeros((B, Zb * nbcov * Pk), np.int32)
    ln = np.zeros_like(st)
    for zi in range(Zb):
        lo, hi = ieee_bounds(tol, _centres(masses, zi))
        fin = np.isfinite(lo) & np.isfinite(hi)
        for k in range(nbcov):
            s0 = np.broadcast_to(bb[:, k, 0:1], (B, Pk))
            s1 = np.broadcast_to(bb[:, k, 1:2], (B, Pk))
            left = _bounded(mz, s0, s1, lo, False, nstep)
            right = _bounded(mz, s0, s1, hi, True, nstep)
            col = (zi * nbcov + k) * Pk + np.arange(Pk)
            st[:, col] = left
            ln[:, col] = np.where(fin & (right > left), right - left, 0)
    return st, ln


def range_masses(tol, nb=4, per_band=300, seed=0):
    """A band-segmented sorted mass table (``nb`` bands, the third empty)
    with runs of equal masses and the six masses around the IEEE bounds
    of six centres in every band, and those centres: (frag_mz, band_off,
    centres)."""
    rng = np.random.default_rng(seed)
    cs = (bound_centres(tol, 6, start=400.0) if tol[0] != "da"
          else np.arange(400.5, 406.5, 1.0).astype(F32))
    segs = []
    for b in range(nb):
        if b == 2:
            segs.append(np.zeros(0, F32))
            continue
        m = rng.uniform(150.0, 2000.0, per_band).astype(F32)
        m[: per_band // 10] = m[0]  # a run of equal masses
        ons = np.concatenate([on_bound_masses(tol, c) for c in cs])
        ons2 = np.concatenate([on_bound_masses(tol, c * F32(2)) for c in cs])
        segs.append(np.sort(np.concatenate([m, ons, ons2]).astype(F32)))
    off = np.concatenate([[0], np.cumsum([s.size for s in segs])])
    return np.concatenate(segs), off.astype(np.int64), cs


def range_peaks(cs, B, Pk, seed):
    """[B, Pk] f32 peak masses: the centres, random masses, NaN, -inf,
    0 and +inf pads."""
    rng = np.random.default_rng(seed)
    m = np.sort(rng.uniform(100.0, 1200.0, (B, Pk)).astype(F32), axis=1)
    for b in range(B):
        m[b, : min(cs.size, Pk)] = cs[: Pk]
        m[b] = np.sort(m[b])
        m[b, Pk - 1 - b % 3:] = np.inf
    m[0, 1] = np.nan
    m[1 % B, 0] = -np.inf
    m[2 % B, 0] = 0.0
    return m


def open_range_tables(topen, frag_mz, band_off, device):
    """The device tables of the open range search for a crafted table."""
    return topen.range_tables(frag_mz, band_off, device)


# ---- the entry gather ------------------------------------------------------

def model_entries(pep, starts, lens, *, F, Wc, Pk, Z, nbcov, chunked,
                  packed):
    """open_entries: the rows [B*nbcov, W] and the tags (or None)."""
    pep = np.asarray(pep, np.int32).reshape(-1)
    starts = np.asarray(starts, np.int64)
    lens = np.asarray(lens, np.int64)
    N = pep.size
    B = starts.shape[0]
    Wn = Z * Pk
    W = Wc * 64 if chunked else F
    keys = np.zeros((B * nbcov, W), np.int32)
    tags = (np.zeros_like(keys) if not packed and Z > 1 else None)
    w = np.arange(Wn)
    z = w // Pk
    j = np.arange(W)
    for rr in range(B * nbcov):
        b, k = divmod(rr, nbcov)
        col = (z * nbcov + k) * Pk + (w - z * Pk)
        st, ln = starts[b, col], lens[b, col]
        if chunked:
            v = np.where(ln > 0, (st + ln + 63) // 64 - st // 64, 0)
        else:
            v = ln
        cum = np.cumsum(v) - v
        total = v.sum()
        if not chunked:
            wj = np.searchsorted(np.minimum(cum, F - 1), j, side="right") - 1
            zt = np.clip(wj, 0, Wn - 1) // Pk + 1
            src = np.clip(st[wj] + j - cum[wj], 0, N - 1)
            p = np.where(j < total, pep[src], -1)
        else:
            r = j // 64
            wj = np.clip(np.searchsorted(np.minimum(cum, Wc), r,
                                         side="right") - 1, 0, Wn - 1)
            zt = wj // Pk + 1
            s, e = st[wj], st[wj] + ln[wj]
            row = np.clip(s // 64 + r - cum[wj], 0, N // 64 - 1)
            pos = row * 64 + j % 64
            g = pep[pos]
            p = np.where((r < total) & (pos >= s) & (pos < e) & (g >= 0), g,
                         -1)
        if packed:
            key = (PMAX - p) if Z == 1 else ((PMAX - p) << 5) | zt
            keys[rr] = np.where(p < 0, INT32_MAX, key)
        else:
            keys[rr] = np.where(p < 0, NOPEP, -p)
            if tags is not None:
                tags[rr] = zt
    return keys, tags


def entries_case(seed, *, B, nbcov, Z, Pk, chunked, F, Wc, N=4096,
                 overflow=False):
    """A fragment-peptide table (-1 pads at its end) and window ranges
    [B, Z*nbcov*Pk]: many empty windows (start 0 or anywhere), windows
    sharing table rows, and with ``overflow`` rows whose total passes F
    (or Wc rows)."""
    rng = np.random.default_rng(seed)
    pep = rng.integers(0, 5000, N).astype(np.int32)
    pep[-70:] = -1
    Wn = Z * nbcov * Pk
    starts = rng.integers(0, N - 80, (B, Wn)).astype(np.int32)
    cap = (Wc * 64 if chunked else F) // (2 * Z * Pk)
    lens = rng.integers(0, max(cap, 2), (B, Wn)).astype(np.int32)
    empty = rng.random((B, Wn)) < 0.3
    lens[empty] = 0
    starts[empty & (rng.random((B, Wn)) < 0.5)] = 0
    if overflow:
        Wout = Wc * 64 if chunked else F
        starts[0] = rng.integers(0, 64, Wn)
        lens[0] = rng.integers(Wout // 2, Wout // 2 + 40, Wn)
        lens[0, -3:] = 0  # trailing empty windows past F
        lens[-1, :] = 70
    lens = np.minimum(lens, N - starts).astype(np.int32)
    return pep, starts, lens


# ---- the run-count top-K ---------------------------------------------------

def warp_first(lo, hi, pred):
    """The kernel's warp-wide search: 32 probes a step, lane l at
    lo + (l + 1) * step - 1, a probe at or past hi counting as true."""
    while lo < hi:
        step = (hi - lo + 31) // 32
        xs = [lo + (lane + 1) * step - 1 for lane in range(32)]
        bal = [x >= hi or pred(x) for x in xs]
        if not any(bal):
            return hi
        f = bal.index(True)
        lo, hi = lo + f * step, min(xs[f], hi)
    return hi


def model_count(rows, zs, row_spec, row_i0, row_i1, row_maxz, *, F, K,
                nbcov, Z, packed, cap=4096, threads=256):
    """open_count: the [R, 2K+2] layout, by the kernel's steps (``cap``
    and ``threads``, the top-K buffer and the block, may be shrunk to
    drive the buffer's compaction at small sizes)."""
    rows = np.asarray(rows, np.int64)
    BN, Wrow = rows.shape
    Fax = min(F, Wrow)
    R = len(row_spec)
    has_z = Z > 1
    out = np.zeros((R, 2 * K + 2), np.int32)

    def live(x):
        return x < NOPEP if not packed else x != INT32_MAX

    def pep(x):
        if not packed:
            return -x
        return PMAX - (x >> 5) if has_z else PMAX - x

    for r in range(R):
        i0, i1, mz = int(row_i0[r]), int(row_i1[r]), int(row_maxz[r])
        buf, thr, mt, sc = [], 0, 0, 0
        for slot in range(nbcov if i0 < i1 else 0):
            p = int(np.clip(int(row_spec[r]) * nbcov + slot, 0, BN - 1))
            row = rows[p]
            zrow = (None if not has_z
                    else (row & 31 if packed else np.asarray(zs)[p]))
            L = warp_first(0, Fax, lambda j: not live(row[j]))
            a = warp_first(0, L, lambda j: pep(row[j]) < i1)
            b = warp_first(a, L, lambda j: pep(row[j]) < i0)
            for base in range(a, b, threads):
                for j in range(base, min(base + threads, b)):
                    pj = pep(row[j])
                    if j != a and pep(row[j - 1]) == pj:
                        continue
                    c, x = 0, j
                    while x < b and pep(row[x]) == pj:
                        c += (not has_z) or int(zrow[x]) < mz
                        x += 1
                    if c > 0:
                        key = (c << 32) | pj
                        mt += c
                        sc += 1
                        if key > thr:
                            buf.append(key)
                if len(buf) > cap - threads:
                    buf = sorted(buf, reverse=True)[:K]
                    thr = buf[K - 1]
        buf = sorted(buf, reverse=True)[:K]
        for i, key in enumerate(buf):
            out[r, i] = key >> 32
            out[r, K + i] = key & 0xFFFFFFFF
        out[r, 2 * K] = mt
        out[r, 2 * K + 1] = sc
    return out


def count_case(seed, *, B, nbcov, F, W, Z, packed, R, band_w=400,
               max_run=6):
    """Sorted entry rows [B*nbcov, W] (the peptides of pseudo-row
    b*nbcov + k all in band k, so bands partition them), their tags, and
    R query rows: random precursor ranges (some empty, some covering
    every band), padding rows of spectrum B with [0, 0), charge bounds
    2-4; the first row holds more live entries than F (a cut row), the
    second none. Returns (rows, zs or None, spec, i0, i1, maxz)."""
    rng = np.random.default_rng(seed)
    BN = B * nbcov
    rows = np.zeros((BN, W), np.int32)
    zs = np.zeros((BN, F), np.int32) if (not packed and Z > 1) else None
    for rr in range(BN):
        k = rr % nbcov
        n_live = {0: W - 3, 1: 0}.get(rr, int(rng.integers(0, W)))
        peps, zt = [], []
        while len(peps) < n_live:
            p = int(rng.integers(k * band_w, (k + 1) * band_w))
            n = int(rng.integers(1, max_run + 1))
            peps += [p] * n
            zt += rng.integers(1, Z + 1, n).tolist()
        peps = np.array(peps[:n_live], np.int64)
        zt = np.array(zt[:n_live], np.int64)
        if packed:
            key = (PMAX - peps) if Z == 1 else ((PMAX - peps) << 5) | zt
            row = np.full(W, INT32_MAX, np.int64)
            row[:n_live] = key
            rows[rr] = np.sort(row)
        else:
            row = np.full(W, NOPEP, np.int64)
            row[:n_live] = -peps
            z_full = np.ones(W, np.int64)
            z_full[:n_live] = zt
            order = np.argsort(row, kind="stable")
            rows[rr] = row[order]
            if zs is not None:
                zs[rr] = z_full[order][:F]
    spec = rng.integers(0, B, R).astype(np.int32)
    spec[: min(B, R)] = np.arange(min(B, R))
    i0 = rng.integers(-5, nbcov * band_w, R)
    i1 = i0 + rng.integers(-3, nbcov * band_w, R)
    i0[-1], i1[-1] = 0, nbcov * band_w  # every band
    pad = rng.random(R) < 0.15
    spec[pad] = B
    i0[pad] = 0
    i1[pad] = 0
    maxz = rng.integers(2, 5, R).astype(np.int32)
    return (rows, zs, spec, np.maximum(i0, 0).astype(np.int32),
            i1.astype(np.int32), maxz)
