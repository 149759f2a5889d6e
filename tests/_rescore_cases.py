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
# has warps, and a block past 48 KB of shared memory
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
    # -inf slots under ppm: NaN bounds match nothing
    fi = base.copy()
    fi[0, 0, 0, 1:4] = -np.inf
    fi[0, 0, 1, :2] = -np.inf
    cases["neg_inf_ppm"] = _one(
        fi, [[300.0, 450.25, 612.5, 800.0, 1000.5, 333.0, np.inf]],
        [[1.0, 2.0, 3.0, 4.0, 5.0, 6.0, -1.0]], [[4]], ("b", "y"), ppm, 3)
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
    return cases
