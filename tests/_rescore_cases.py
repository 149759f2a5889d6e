"""Inputs of the candidate rescore (``rescore_candidate``) for the tests:
numpy arrays made from a seed, shared by the CPU tests against
``sage_tpu`` and the card's kernel-against-plain tests. Imports numpy
only.

A case is a dict: ``f`` f32 [n, k, S, L] ladders (-inf in invalid
slots), ``pkm`` / ``pki`` f32 [n, Pk] peak masses and intensities
(pads +inf / -1; the random cases in mass order, as a search gives
them), ``maxz`` i32 [n, k], and the keyword
arguments ``series``, ``frag_tol`` (kind, lo, hi) and ``Z``.
"""

import numpy as np

F32 = np.float32
SERIES = (("y",), ("b", "y"), ("a", "b", "x", "y"))
TOLS = {"ppm": ("ppm", -10.0, 10.0), "pct": ("pct", -0.001, 0.002),
        "da": ("da", -0.02, 0.02)}

# (series, L, Pk, Z, tolerance, n, k): every series set, L, Pk, Z and
# tolerance kind of the random cases at least twice
RANDOM = [
    (SERIES[0], 7, 1, 1, "ppm", 6, 3),
    (SERIES[0], 33, 64, 3, "da", 4, 5),
    (SERIES[0], 33, 17, 2, "pct", 4, 4),
    (SERIES[1], 7, 17, 2, "pct", 5, 4),
    (SERIES[1], 33, 17, 3, "ppm", 4, 6),
    (SERIES[1], 7, 64, 1, "da", 3, 9),
    (SERIES[2], 7, 64, 3, "ppm", 3, 4),
    (SERIES[2], 33, 1, 2, "da", 8, 3),
    (SERIES[2], 33, 17, 1, "pct", 3, 5),
    (SERIES[2], 7, 17, 3, "da", 5, 3),
]
# The card's own shapes, by name: one item a row (k = 1, as the
# two-dispatch path and the grid call it), more items a row than a block
# has warps, and the widest ladder (4 series of 64 ions, Z = 4; the name
# recalls an earlier kernel, for which this shape took more than 48 KB
# of shared memory)
CARD_SHAPES = {
    "k1": (SERIES[1], 47, 150, 3, "ppm", 300, 1),
    "warps": (SERIES[1], 47, 150, 3, "da", 40, 50),
    "smem_48k": (SERIES[2], 64, 200, 4, "ppm", 6, 20),
}


def shape_case(shape, seed_extra=0):
    """``random_case`` at one of the shapes above, seeded from the
    shape."""
    series, L, Pk, Z, tol, n, k = shape
    return random_case(L * 100 + Pk + Z + seed_extra, n, k, series, L, Pk,
                       Z, TOLS[tol])


def _near(rng, mz, tol, size):
    """Masses inside (mostly) or just outside the tolerance window of
    ``mz``."""
    kind, lo, hi = tol
    u = rng.uniform(1.3 * lo, 1.3 * hi, size)
    if kind == "ppm":
        return mz + mz * u / 1e6
    if kind == "pct":
        return mz + mz * u / 100.0
    return mz + u


def random_case(seed, n, k, series, L, Pk, Z, tol):
    """Ladders of ascending masses with -inf slots, and peaks of which
    about half lie near the items' fragments at charges 1..Z (intensities
    from a small set, so ties and zeros occur), the rest noise, then +inf
    / -1 pads (the last row all pads); maxz from 0 to Z + 1."""
    rng = np.random.default_rng(seed)
    S = len(series)
    steps = rng.uniform(57.0, 186.0, (n, k, S, L))
    f = (rng.uniform(0.0, 200.0, (n, k, S, 1)) + steps.cumsum(-1)).astype(F32)
    f[rng.random(f.shape) < 0.15] = -np.inf
    pkm = np.full((n, Pk), np.inf, F32)
    pki = np.full((n, Pk), -1.0, F32)
    for r in range(n):
        live = 0 if r == n - 1 else int(rng.integers(1, Pk + 1))
        fin = f[r][np.isfinite(f[r])]
        n_near = min((live + 1) // 2, fin.size)
        near = []
        if n_near:
            pick = rng.choice(fin, n_near)
            z = rng.integers(1, Z + 1, n_near).astype(F32)
            near = _near(rng, pick.astype(np.float64) / z, tol, n_near)
        noise = rng.uniform(50.0, 2000.0, live - n_near)
        m = np.sort(np.concatenate([np.asarray(near, np.float64), noise]))
        pkm[r, :live] = m.astype(F32)
        pki[r, :live] = rng.choice(
            np.array([0.0, 1.0, 5.0, 5.0, 30.5, 100.0, 2.5e4], F32), live)
    maxz = rng.integers(0, Z + 2, (n, k)).astype(np.int32)
    return dict(f=f, pkm=pkm, pki=pki, maxz=maxz, series=tuple(series),
                frag_tol=tol, Z=Z)


def _one(f, pkm, pki, maxz, series, tol, Z):
    f = np.asarray(f, F32)
    return dict(f=f, pkm=np.asarray(pkm, F32), pki=np.asarray(pki, F32),
                maxz=np.asarray(maxz, np.int32).reshape(f.shape[:2]),
                series=series, frag_tol=tol, Z=Z)


def crafted_cases():
    """The edge cases, by name."""
    ppm, da = TOLS["ppm"], TOLS["da"]
    base = np.array([[300.0, 450.25, 612.5, 800.0, 950.125],
                     [1000.5, 850.0, 700.75, 525.0, 333.0]],
                    F32).reshape(1, 1, 2, 5)
    cases = {}
    # three peaks of one intensity in one window: the greatest mass wins
    # (the plain version's rule), not the first index
    m = [450.249, 450.25, 450.251, 612.5, 700.75]
    cases["equal_intensities"] = _one(
        base, [m], [[7.0, 7.0, 7.0, 3.0, 7.0]], [[3]], ("b", "y"), da, 2)
    # equal intensities at equal and at descending masses
    m = [450.251, 450.25, 450.25, 850.0, 850.0]
    cases["equal_intensities_unsorted"] = _one(
        base, [m], [[7.0, 9.0, 9.0, 2.0, 2.0]], [[2]], ("b", "y"), da, 1)
    # zero-intensity peaks qualify (>= 0) and add 0
    m = [300.0, 450.25, 612.5, 800.0, 1000.5]
    cases["zero_intensity"] = _one(
        base, [m], [[0.0, 0.0, 4.0, 0.0, 0.0]], [[4]], ("b", "y"), ppm, 3)
    # a 0.0 slot against a 0.0 peak under a Da tolerance: denom == 0
    f0 = base.copy()
    f0[0, 0, 0, 0] = 0.0
    f0[0, 0, 1, 2] = 0.0
    cases["zero_denom"] = _one(
        f0, [[0.0, 0.01, 450.25, 700.75, np.inf]],
        [[3.0, 2.0, 1.0, 2.0, -1.0]], [[3]], ("b", "y"), da, 2)
    # the same in mass order, as the kernel requires
    m = [450.25, 450.25, 450.251, 850.0, 850.0]
    cases["equal_intensities_sorted"] = _one(
        base, [m], [[9.0, 9.0, 7.0, 2.0, 2.0]], [[2]], ("b", "y"), da, 1)
    # -inf slots under ppm: NaN bounds match nothing
    fi = base.copy()
    fi[0, 0, 0, 1:4] = -np.inf
    fi[0, 0, 1, :2] = -np.inf
    cases["neg_inf_ppm"] = _one(
        fi, [[300.0, 450.25, 612.5, 800.0, 1000.5, 333.0, np.inf]],
        [[1.0, 2.0, 3.0, 4.0, 5.0, 6.0, -1.0]], [[4]], ("b", "y"), ppm, 3)
    # the same row in mass order
    cases["neg_inf_ppm_sorted"] = _one(
        fi, [[300.0, 333.0, 450.25, 612.5, 800.0, 1000.5, np.inf]],
        [[1.0, 6.0, 2.0, 3.0, 4.0, 5.0, -1.0]], [[4]], ("b", "y"), ppm, 3)
    # rows made entirely of +inf / -1 pads
    cases["all_pads"] = _one(
        np.concatenate([base, base]).reshape(2, 1, 2, 5),
        np.full((2, 4), np.inf), np.full((2, 4), -1.0), [[3], [2]],
        ("b", "y"), ppm, 2)
    # n * k == 0: no row, and rows with no item
    cases["no_rows"] = _one(
        np.zeros((0, 3, 2, 5)), np.zeros((0, 4)), np.zeros((0, 4)),
        np.zeros((0, 3)), ("b", "y"), ppm, 2)
    cases["no_items"] = _one(
        np.zeros((2, 0, 2, 5)), np.full((2, 4), np.inf),
        np.full((2, 4), -1.0), np.zeros((2, 0)), ("b", "y"), da, 2)
    cases.update(_search_edge_cases())
    return cases


def rows_ascend(pkm):
    """Whether every peak row ascends in mass (the +inf pads last): the
    precondition of the rescore kernel's binary search."""
    pkm = np.asarray(pkm, F32)
    return bool(np.all(pkm[:, 1:] >= pkm[:, :-1]))


def kernel_cases():
    """The crafted cases that meet the kernel's precondition, by name:
    the plain version, like ``sage_tpu``, takes peaks in any order, so
    the unsorted cases are held against ``sage_tpu`` on the CPU only."""
    return {name: c for name, c in crafted_cases().items()
            if rows_ascend(c["pkm"])}


# ---- exact tolerance bounds ---------------------------------------------

_SCALE = {"ppm": 1e6, "pct": 100.0}


def ieee_bounds(tol, c):
    """tol_bounds_static's bounds of the f32 centres ``c`` with every op
    an IEEE f32 op in the reference's order: c + (c * lo) / s (ppm,
    pct) or c + lo (da)."""
    kind, lo, hi = tol
    c = np.asarray(c, F32)
    with np.errstate(all="ignore"):
        if kind == "da":
            return c + F32(lo), c + F32(hi)
        s = F32(_SCALE[kind])
        return c + (c * F32(lo)) / s, c + (c * F32(hi)) / s


def folded_bounds(tol, c):
    """The same bounds as XLA's algebraic simplifier compiles them on the
    CPU: the constant quotient folded first, c + c * (lo / s)."""
    kind, lo, hi = tol
    c = np.asarray(c, F32)
    s = F32(_SCALE[kind])
    return c + c * (F32(lo) / s), c + c * (F32(hi) / s)


def bound_centres(tol, count, start=300.0, span=1 << 23):
    """``count`` f32 values from ``start`` on whose IEEE bounds differ
    from the folded ones (either bound), each at least 1 Da above the
    one before, so that their windows are disjoint."""
    base = np.array([start], F32).view(np.int32)[0]
    c = np.arange(base, base + span, dtype=np.int32).view(F32)
    (lo_i, hi_i), (lo_f, hi_f) = ieee_bounds(tol, c), folded_bounds(tol, c)
    out = []
    for x in c[(lo_i != lo_f) | (hi_i != hi_f)]:
        if not out or x >= out[-1] + 1.0:
            out.append(x)
    assert len(out) >= count, (tol, len(out))
    return np.array(out[:count], F32)


def on_bound_masses(tol, c):
    """Six masses around centre ``c``'s IEEE window: its low bound one
    ulp below, on it and one ulp above, then its high bound likewise.
    The four middle ones lie in the window, the outer two outside."""
    lo, hi = (np.asarray(b, F32) for b in ieee_bounds(tol, c))
    down, up = F32(-np.inf), F32(np.inf)
    return np.array([np.nextafter(lo, down), lo, np.nextafter(lo, up),
                     np.nextafter(hi, down), hi, np.nextafter(hi, up)], F32)


def on_bound_case(tol, count=3):
    """Rescore items whose peaks lie exactly on their slots' IEEE bounds
    and one ulp either side, at centres where the folded bounds differ.
    Row 2i and 2i + 1 share centre i: one b and one y slot at the centre
    (fragment charge 1 only, maxz 2), and the six peaks of
    ``on_bound_masses`` then +inf pads. In row 2i the low-bound peak is
    the most intense in-window peak, in row 2i + 1 the high-bound one;
    the outer peaks are more intense still, so a bound one ulp too wide
    or too narrow changes the match."""
    cs = bound_centres(tol, count)
    n = 2 * count
    f = np.full((n, 1, 2, 3), -np.inf, F32)
    pkm = np.full((n, 8), np.inf, F32)
    pki = np.full((n, 8), -1.0, F32)
    for i, c in enumerate(cs):
        for r, inten in ((2 * i, [100.0, 9.0, 1.0, 2.0, 8.0, 100.0]),
                         (2 * i + 1, [100.0, 8.0, 1.0, 2.0, 9.0, 100.0])):
            f[r, 0, 0, 1] = c
            f[r, 0, 1, 2] = c
            pkm[r, :6] = on_bound_masses(tol, c)
            pki[r, :6] = inten
    return dict(f=f, pkm=pkm, pki=pki, maxz=np.full((n, 1), 2, np.int32),
                series=("b", "y"), frag_tol=tol, Z=1)


def _search_edge_cases():
    """The binary search's edge cases, by name: on-bound peaks (ppm and
    pct), repeated masses, removed peaks (intensity -1) inside the row,
    a window with lo > hi, and -inf slots under da against a row that
    starts with -inf masses."""
    da = TOLS["da"]
    base = np.array([[300.0, 450.25, 612.5, 800.0, 950.125],
                     [1000.5, 850.0, 700.75, 525.0, 333.0]],
                    F32).reshape(1, 1, 2, 5)
    cases = {"on_bounds_ppm": on_bound_case(TOLS["ppm"]),
             "on_bounds_pct": on_bound_case(("pct", -0.001, 0.002))}
    # runs of equal masses, intensities varying within a run
    m = [450.24, 450.25, 450.25, 450.25, 612.5, 612.5, 850.0, 850.0,
         850.0, np.inf]
    cases["equal_masses"] = _one(
        base, [m], [[3.0, 5.0, 7.0, 5.0, 2.0, 2.0, 4.0, 4.0, 1.0, -1.0]],
        [[3]], ("b", "y"), da, 2)
    # removed peaks keep their mass with intensity -1 (chimera rounds)
    m = [300.0, 450.25, 450.26, 612.5, 700.75, 850.0, 1000.5, np.inf]
    cases["removed_peaks"] = _one(
        base, [m], [[-1.0, -1.0, 3.0, -1.0, 6.0, -1.0, 2.0, -1.0]], [[3]],
        ("b", "y"), da, 2)
    # lo > hi: an empty window at every slot
    cases["lo_above_hi"] = _one(
        base, [[300.0, 450.25, 612.5, 850.0, np.inf]],
        [[1.0, 2.0, 3.0, 4.0, -1.0]], [[3]], ("b", "y"),
        ("da", 0.02, -0.02), 2)
    # under da a -inf slot's window is [-inf, -inf]: it matches the row's
    # -inf masses, which an ascending row holds first
    fi = base.copy()
    fi[0, 0, 0, 1:3] = -np.inf
    cases["neg_inf_da"] = _one(
        fi, [[-np.inf, -np.inf, 300.0, 612.5, 850.0, np.inf]],
        [[2.0, 5.0, 1.0, 3.0, 4.0, -1.0]], [[3]], ("b", "y"), da, 2)
    return cases


def indexed_case(seed, shape):
    """``shape_case``'s items in the indexed form: the ladders as rows of
    a table ``lad`` [P, S, L] (shuffled, with rows no item reads), the
    peaks as rows of ``pkm`` / ``pki`` [B, Pk] (shuffled, with one extra
    row of pads), ``pep`` [n, k] and ``spec`` [n] pointing at them, and
    ``live`` [n] (row 0 all live, row 1 all dead, the rest drawn; dead
    items' ``pep`` is -1)."""
    c = shape_case(shape, seed_extra=seed)
    rng = np.random.default_rng(seed)
    n, k, S, L = c["f"].shape
    P = n * k + 3
    perm = rng.permutation(P)
    lad = np.full((P, S, L), -np.inf, F32)
    lad[perm[: n * k]] = c["f"].reshape(n * k, S, L)
    lad[perm[n * k:]] = c["f"].reshape(n * k, S, L)[: P - n * k][::-1]
    pep = perm[: n * k].reshape(n, k).astype(np.int32)
    order = rng.permutation(n + 1)  # row order[b] holds item row b's peaks
    Pk = c["pkm"].shape[1]
    pkm = np.full((n + 1, Pk), np.inf, F32)
    pki = np.full((n + 1, Pk), -1.0, F32)
    pkm[order[:n]], pki[order[:n]] = c["pkm"], c["pki"]
    live = rng.integers(0, k + 1, n).astype(np.int32)
    live[0] = k
    if n > 1:
        live[1] = 0
    pep[np.arange(k)[None, :] >= live[:, None]] = -1
    return dict(lad=lad, pep=pep, spec=order[:n].astype(np.int32), pkm=pkm,
                pki=pki, maxz=c["maxz"], live=live, series=c["series"],
                frag_tol=c["frag_tol"], Z=c["Z"])


def large_peak_arrays(db, n, n_peaks, seed, charge=4):
    """``n`` raw spectra of ``n_peaks`` peaks each (m/z and intensity
    arrays, unsorted, as a reader gives them) for a search that keeps
    that many peaks (``max_peaks``): one peptide's b/y ions, the rest
    noise over the fragment range, the precursor the peptide's at
    ``charge`` (so fragment charges up to 3 are live). Plain dicts of
    numpy arrays for either package's RawSpectrum."""
    rng = np.random.default_rng(seed)
    b, y = db.table.ladders()
    targets = np.flatnonzero(db.table.lens >= 8)
    proton = 1.007276466812
    out = []
    for _ in range(n):
        p = int(targets[rng.integers(0, targets.size)])
        m = int(db.table.lens[p]) - 1
        frags = np.concatenate([b[p, :m], y[p, :m]]).astype(np.float64)
        noise = rng.uniform(100.0, 2500.0, n_peaks - frags.size)
        mz = np.concatenate([frags, noise]) + proton
        out.append({
            "mz": rng.permutation(mz).astype(F32),
            "intensity": rng.uniform(1.0, 1e5, n_peaks).astype(F32),
            "prec_mz": float(db.table.mono[p]) / charge + proton,
            "charge": charge,
        })
    return out
