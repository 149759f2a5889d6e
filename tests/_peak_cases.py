"""Inputs and numpy models for the peak-major searches' three kernels:
the window-range search (``csrc/peak_ranges.cu``, open and banded
forms), the entry gather (``csrc/open_entries.cu``) and the run-count
top-K (``csrc/open_count.cu``).

Each model follows its kernel's algorithm step for step (the range
search's binary searches; the gather's capped scan, owner map, copies
through it, tail fill and overflow fix-up; the count's searches of each
band pseudo-row's window, its runs counted by mask sums over 32-position
steps (warp form) or walked (block form), and the K-sized threshold
buffer of the top-K), so the
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

ENTRIES_TILE = 2048       # windows a tile of the kernel holds
ENTRIES_UNIT_TILE = 4096  # units a slice of its owner map holds
_MARK = -7777             # an element no copy and no fill has written


def entries_smem_bytes(Z, Pk, units):
    """The gather kernel's dynamic shared memory in bytes, as
    ``csrc/open_entries.cu:open_entries_smem_bytes`` sizes it for the
    model's tiles: one tile's capped prefix, starts and lengths, 4 bytes
    each a window, up to ENTRIES_TILE windows (and one prefix more), and
    one slice of the owner map, 2 bytes a unit (``units``: F, or Wc row
    slots when row-aligned), up to ENTRIES_UNIT_TILE, rounded up to 16
    bytes."""
    tw = min(Z * Pk, ENTRIES_TILE)
    tu = min(units, ENTRIES_UNIT_TILE)
    return 4 * (3 * tw + 1) + -(-2 * tu // 16) * 16


def sat_scan(v, cap, carry=0):
    """The kernel's capped exclusive scan of ``v`` (values >= 0) from
    ``carry``: each prefix and the running sum capped at ``cap`` after
    every addition (saturating addition on values >= 0 is associative,
    so the kernel's grouping into lanes, warps and passes changes
    nothing). Returns (prefixes, capped total)."""
    out = np.empty(len(v), np.int64)
    run = int(carry)
    for i, x in enumerate(np.minimum(np.asarray(v, np.int64), cap)):
        out[i] = run
        run = min(run + int(x), cap)
    return out, run


def _enc(p, zt, Z, packed):
    p = np.asarray(p, np.int64)
    if packed:
        key = (PMAX - p) if Z == 1 else ((PMAX - p) << 5) | zt
        return np.where(p < 0, INT32_MAX, key)
    return np.where(p < 0, NOPEP, -p)


def model_entries(pep, starts, lens, *, F, Wc, Pk, Z, nbcov, chunked,
                  packed, tile=ENTRIES_TILE, unit_tile=ENTRIES_UNIT_TILE):
    """open_entries: the rows [B*nbcov, W], the tags (or None) and the live
    counts, by the kernel's steps. Per row, tiles of ``tile`` windows: a
    prefix capped at F - 1 (flat) or Wc (row-aligned), so that window w
    covers units [cum[w], cum[w + 1]) of the row (units: elements, or
    64-entry row slots); in slices of ``unit_tile`` units an owner map,
    each window's index written over its own units, then every unit
    copied through its owner (flat: fragment start + unit - cum; a row
    slot: the owner's table row start // 64 + slot - cum, each entry
    masked to the owner's [s, e)). The tail past the copies is filled with
    the no-entry key and the tag Z, and a flat row whose total reaches F
    has entry F - 1 read through the last window. ``tile`` and
    ``unit_tile`` may be shrunk to cross tiles and slices at small
    sizes. Asserts that the copies and the fill write every element
    once."""
    pep = np.asarray(pep, np.int32).reshape(-1)
    starts = np.asarray(starts, np.int64)
    lens = np.asarray(lens, np.int64)
    N = pep.size
    B = starts.shape[0]
    Wn = Z * Pk
    W = Wc * 64 if chunked else F
    cap = Wc if chunked else F - 1
    keys = np.zeros((B * nbcov, W), np.int32)
    tags = (np.zeros_like(keys) if not packed and Z > 1 else None)
    live = np.zeros(B * nbcov, np.int32)
    w_all = np.arange(Wn)
    z_all = w_all // Pk
    lane = np.arange(64)
    for rr in range(B * nbcov):
        b, k = divmod(rr, nbcov)
        col = (z_all * nbcov + k) * Pk + (w_all - z_all * Pk)
        st, ln = starts[b, col], lens[b, col]
        v = (np.where(ln > 0, (st + ln + 63) // 64 - st // 64, 0) if chunked
             else ln)
        krow = np.full(W, _MARK, np.int64)
        zrow = np.full(W, _MARK, np.int64)
        carry = n_live = 0
        for t0 in range(0, Wn, tile):
            ws = np.arange(t0, min(t0 + tile, Wn))
            cum, carry = sat_scan(v[ws], cap, carry)
            cum = np.append(cum, carry)  # window w: units [cum, cum next)
            for e0 in range(int(cum[0]), carry, unit_tile):
                e1 = min(e0 + unit_tile, carry)
                own = np.full(e1 - e0, -1, np.int64)
                for i in range(ws.size):
                    a, c1 = max(cum[i], e0), min(cum[i + 1], e1)
                    own[a - e0: max(c1, a) - e0] = i
                assert (own >= 0).all()
                units = np.arange(e0, e1)
                w = ws[own]
                c = cum[own]
                zt = w // Pk + 1
                if not chunked:
                    p = pep[np.clip(st[w] + units - c, 0, N - 1)]
                    dst = units
                else:
                    rows = np.clip(st[w] // 64 + units - c, 0, N // 64 - 1)
                    pos = rows[:, None] * 64 + lane
                    g = pep[pos]
                    p = np.where((pos >= st[w][:, None])
                                 & (pos < (st[w] + ln[w])[:, None])
                                 & (g >= 0), g, -1).reshape(-1)
                    zt = np.repeat(zt, 64)
                    dst = (units[:, None] * 64 + lane).reshape(-1)
                assert (krow[dst] == _MARK).all()
                krow[dst] = _enc(p, zt, Z, packed)
                zrow[dst] = zt
                n_live += int((p >= 0).sum())
        total = int(v.sum())
        tail = carry * 64 if chunked else carry
        assert (krow[:tail] != _MARK).all() and (krow[tail:] == _MARK).all()
        krow[tail:] = _enc(-1, Z, Z, packed)
        zrow[tail:] = Z
        if not chunked and total >= F:
            wl = Wn - 1
            src = st[wl] + (F - 1) - (total - ln[wl])
            p = int(pep[np.clip(src, 0, N - 1)])
            krow[F - 1] = _enc(p, Z, Z, packed)
            zrow[F - 1] = Z
            n_live += p >= 0
        keys[rr] = krow
        if tags is not None:
            tags[rr] = zrow
        live[rr] = n_live
    return keys, tags, live


def live_count(keys, packed):
    """i32 [rows]: the keys of each row that hold an entry."""
    keys = np.asarray(keys)
    return (keys != (INT32_MAX if packed else NOPEP)).sum(
        axis=1).astype(np.int32)


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

WARP_MAX_K = 64  # the largest K of the kernel's warp form


def first_true(lo, hi, pred):
    """A thread's binary search, as the count kernel's block form runs one
    for each end of each band pseudo-row's window: the first x in
    [lo, hi) where pred holds, hi if none (pred false, then true)."""
    while lo < hi:
        mid = (lo + hi) // 2
        if pred(mid):
            hi = mid
        else:
            lo = mid + 1
    return lo


def group_first(lo, hi, pred, G):
    """The warp form's search by a group of G lanes: G probes a step at
    lo + (i + 1) * step - 1, step = ceil((hi - lo) / (G + 1)), a probe at
    or past hi counting as true; the range shrinks to the one between the
    last false probe and the first true one. The first x in [lo, hi)
    where pred holds, hi if none."""
    while lo < hi:
        step = (hi - lo + G) // (G + 1)
        t = [x >= hi or pred(x)
             for x in (lo + (i + 1) * step - 1 for i in range(G))]
        f = t.index(True) if True in t else G
        x = lo + (f + 1) * step - 1
        lo += f * step
        hi = x if f < G and x < hi else hi
    return lo


def search_group(ns):
    """The lanes a search of the warp form for ``ns`` band pseudo-rows at
    once (two searches each): the largest power of two G <= 16 with
    2 * ns * G <= 32."""
    G = 16
    while G > 1 and 2 * ns * G > 32:
        G //= 2
    return G


def count_buffer(K, threads):
    """The top-K buffer's keys: 128 in the warp form (32 positions a
    step), else the least power of two >= 2K + threads."""
    if threads == 32:
        return 128
    n = 2 * K + threads
    return 1 << (n - 1).bit_length()


class _TopK:
    """The kernel's buffer behind its threshold: keys above it appended;
    past cap - step keys, sorted, cut to K and the threshold raised."""

    def __init__(self, K, cap, step):
        self.K, self.cap, self.step = K, cap, step
        self.buf, self.thr = [], 0
        assert cap - step >= K

    def offer(self, keys):
        self.buf += [k for k in keys if k > self.thr]
        assert len(self.buf) <= self.cap
        if len(self.buf) > self.cap - self.step:
            self.buf = sorted(self.buf, reverse=True)[:self.K]
            self.thr = self.buf[self.K - 1]

    def top(self):
        return sorted(self.buf, reverse=True)[:self.K]


def model_count(rows, zs, live, row_spec, row_i0, row_i1, row_maxz, *, F,
                K, nbcov, Z, packed, form=None, cap=None, step=None):
    """open_count: the [R, 2K+2] layout, by the kernel's steps. ``form``:
    "warp" (the kernel's for K <= 64) or "block" (past it), chosen by K
    when None; ``cap``, the top-K buffer, the form's own when None, and
    the block form's ``step``, 256 positions when None, may be shrunk to
    drive the buffer's compaction at small sizes.

    The warp form takes up to 16 band pseudo-rows at once: both ends of
    each window [a, b) within the live prefix [0, min(live, Fax)) found
    by searches of G lanes (:func:`group_first`); then each window 32
    positions a step, a run's count the sum of its positions' charge mask
    within the step, the run still open at a step's end carried into the
    next and offered when it ends, before the runs that start in that
    step, each offered in lane order. The block form searches each window
    by binary searches (:func:`first_true`), then a thread at each run's
    first position walks the run, 256 positions a step."""
    rows = np.asarray(rows, np.int64)
    live = np.asarray(live, np.int64)
    BN, Wrow = rows.shape
    Fax = min(F, Wrow)
    R = len(row_spec)
    has_z = Z > 1
    form = form or ("warp" if K <= WARP_MAX_K else "block")
    assert step is None or form == "block", "the warp form steps by 32"
    step = 32 if form == "warp" else (step or 256)
    cap = cap or count_buffer(K, step)
    out = np.zeros((R, 2 * K + 2), np.int32)

    def pep(x):
        if not packed:
            return -x
        return PMAX - (x >> 5) if has_z else PMAX - x

    for r in range(R):
        i0, i1, mz = int(row_i0[r]), int(row_i1[r]), int(row_maxz[r])
        top = _TopK(K, cap, step)
        mt = sc = 0
        group = 16 if form == "warp" else nbcov
        for s0 in range(0, nbcov if i0 < i1 else 0, group):
            slots = []
            G = search_group(min(nbcov - s0, 16))
            for slot in range(s0, min(s0 + group, nbcov)):
                p = int(np.clip(int(row_spec[r]) * nbcov + slot, 0, BN - 1))
                row = rows[p]
                n = int(np.clip(live[p], 0, Fax))
                ends = []
                for bound in (i1, i0):
                    def pred(j, row=row, bound=bound):
                        return pep(row[j]) < bound
                    ends.append(group_first(0, n, pred, G) if form == "warp"
                                else first_true(0, n, pred))
                slots.append((p, *ends))
            for p, a, b in slots:
                row = rows[p]
                zrow = (None if not has_z
                        else (row & 31 if packed else np.asarray(zs)[p]))

                def ok(j):
                    return (not has_z) or int(zrow[j]) < mz

                if form == "block":
                    for base in range(a, b, step):
                        keys = []
                        for j in range(base, min(base + step, b)):
                            pj = pep(row[j])
                            if j != a and pep(row[j - 1]) == pj:
                                continue
                            c, x = 0, j
                            while x < b and pep(row[x]) == pj:
                                c += ok(x)
                                x += 1
                            if c > 0:
                                keys.append((c << 32) | pj)
                                mt += c
                                sc += 1
                        top.offer(keys)
                    continue
                is_open, cc, cp = False, 0, 0
                for base in range(a, b, 32):
                    js = list(range(base, min(base + 32, b)))
                    ps = [pep(row[j]) for j in js]
                    oks = [ok(j) for j in js]
                    st = [i for i, j in enumerate(js)
                          if j == a or ps[i] != (ps[i - 1] if i else cp)]
                    last = base + 32 >= b
                    if is_open:
                        fs = st[0] if st else 32
                        cc += sum(oks[:fs])
                        if st or last:
                            is_open = False
                            keys = []
                            if cc > 0:
                                keys.append((cc << 32) | cp)
                                mt += cc
                                sc += 1
                            top.offer(keys)
                    keys = []
                    for n_i, i in enumerate(st):
                        if i == st[-1] and not last:
                            continue
                        end = st[n_i + 1] if n_i + 1 < len(st) else 32
                        c = sum(oks[i:end])
                        if c > 0:
                            keys.append((c << 32) | ps[i])
                            mt += c
                            sc += 1
                    top.offer(keys)
                    if st and not last:
                        is_open, cc, cp = True, sum(oks[st[-1]:]), ps[st[-1]]
        for i, key in enumerate(top.top()):
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
    second none. Returns (rows, zs or None, live, spec, i0, i1, maxz),
    live each row's count of live keys, in open_count's argument order."""
    rng = np.random.default_rng(seed)
    BN = B * nbcov
    rows = np.zeros((BN, W), np.int32)
    zs = np.zeros((BN, F), np.int32) if (not packed and Z > 1) else None
    live = np.zeros(BN, np.int32)
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
        live[rr] = n_live
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
    return (rows, zs, live, spec, np.maximum(i0, 0).astype(np.int32),
            i1.astype(np.int32), maxz)
