"""The plain reference that decides ``correct``.

NumPy only; it imports nothing of the program under test. It judges what
the program's timed path produced against values it works out again from
the benchmark's own inputs (the proteome, the spectra and the
configuration):

* the search: for each spectrum of a seeded sample, the reported PSM's
  peptide is read back from its display string and, from the sequence,
  the config's mods and the spectrum's peaks, the reference recomputes
  its precursor windows (one per searched isotope error) and the isotope
  error the PSM has to report, its b/y ion ladders (f32, the engine's order of
  operations), the most intense peak within the fragment tolerance of
  each ion and charge, the matched counts, the longest runs and the
  hyperscore (Sage's ``scoring.rs``). The peptide the spectrum was drawn
  from is scored too: no reported PSM may score below it.
* rescoring and FDR: from the PSM features as the program left them
  (the one stage the reference follows from the program's own state),
  Sage's linear discriminant (``linear_discriminant.rs``: class means,
  within-class scatter, Gauss-Jordan with its ``eps`` retry), the KDE
  posterior error (``kde.rs``), and q-values at spectrum (``qvalue.rs``),
  peptide and protein level (``fdr.rs`` picked competition), the decoy
  labels and protein lists recomputed from the proteome.

``precision="low"`` computes the same in the next precision down
(bfloat16 ion ladders, float32 discriminant and densities): the control
that has to come out not correct.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from .proteome import NEUTRON, Enzyme, Mods, Peptide, parse_display, PROTON

F32 = np.float32

# ---------------------------------------------------------------------------
# the search


def tol_bounds(kind: str, lo: float, hi: float, center):
    """A tolerance window in f32: ``c + (c * lo) / s`` for ppm (s = 1e6)
    and pct (s = 100), ``c + lo`` for Da (Sage's ``mass.rs``)."""
    c = np.asarray(center, np.float32)
    lo32, hi32 = F32(lo), F32(hi)
    if kind in ("ppm", "pct"):
        s = F32(1e6 if kind == "ppm" else 100.0)
        return (c + (c * lo32) / s).astype(np.float32), \
            (c + (c * hi32) / s).astype(np.float32)
    return (c + lo32).astype(np.float32), (c + hi32).astype(np.float32)


def _lnfact(n: int) -> float:
    if n == 0:
        return 1.0
    x = float(n)
    return x * math.log(x) - x + 0.5 * math.log(x) + 0.5 * math.log(2 * math.pi * x)


def _longest_run(flags: np.ndarray) -> int:
    """Longest run of consecutive matched ions, ion 0 not counted
    (Sage's ``Run`` automaton over one series)."""
    best = cur = 0
    for k in range(1, flags.size):
        cur = cur + 1 if flags[k] else 0
        best = max(best, cur)
    return best


def score_peptide(pep: Peptide, charge: int, masses: np.ndarray,
                  intens: np.ndarray, frag_tol: Tuple[str, float, float],
                  max_frag_charge: Optional[int], low: bool = False) -> dict:
    """Sage's ``score_candidate`` for one peptide against one processed
    spectrum (neutral f32 masses ascending, f32 intensities)."""
    b, y = pep.ladders()
    if low:
        b, y = bf16(b), bf16(y)
    cap = (max_frag_charge + 1) if max_frag_charge is not None else charge
    maxz = max(min(charge, cap), 2)
    out = {}
    for name, lad in (("b", b), ("y", y)):
        summed = F32(0.0)
        matched = 0
        flags = np.zeros(lad.size, bool)
        for k in range(lad.size):
            for z in range(1, maxz):
                mz = F32(lad[k] / F32(z))
                lo, hi = tol_bounds(frag_tol[0], frag_tol[1], frag_tol[2], mz)
                i = int(np.searchsorted(masses, lo, "left"))
                j = int(np.searchsorted(masses, hi, "right"))
                if j <= i:
                    continue
                seg = intens[i:j]
                best = i + int(np.flatnonzero(seg == seg.max())[-1])
                summed = F32(summed + intens[best])
                matched += 1
                flags[k] = True
        out["m" + name] = matched
        out["s" + name] = summed
        out["longest_" + name] = _longest_run(flags)
    i = float(F32(out["sb"] + F32(1.0))) * float(F32(out["sy"] + F32(1.0)))
    hs = math.log(i) + _lnfact(out["mb"]) + _lnfact(out["my"])
    out["hyperscore"] = hs if math.isfinite(hs) else 255.0
    out["matched_peaks"] = out["mb"] + out["my"]
    return out


def bf16(x: np.ndarray) -> np.ndarray:
    """Round f32 values to bfloat16 (round to nearest even) and back."""
    u = np.asarray(x, np.float32).view(np.uint32).astype(np.uint64)
    u = (u + 0x7FFF + ((u >> 16) & 1)) & 0xFFFF0000
    return u.astype(np.uint32).view(np.float32)


def precursor_mass(prec_mz: float, charge: int) -> np.float32:
    """The observed neutral precursor mass, ``(f32(mz) - PROTON) * z``."""
    return F32(F32(F32(prec_mz) - PROTON) * F32(charge))


def in_window(mono, expmass, prec_tol: Tuple[str, float, float]) -> bool:
    """Is ``mono`` inside the precursor window of ``expmass``, with a
    relative slack of 1e-6 so that the f32 rounding of either side
    cannot decide it."""
    lo, hi = tol_bounds(prec_tol[0], prec_tol[1], prec_tol[2], expmass)
    slack = 1e-6 * float(abs(expmass))
    return float(lo) - slack <= float(mono) <= float(hi) + slack


def isotope_windows(mono, expmass, prec_tol: Tuple[str, float, float],
                    isotopes: Sequence[int]) -> List[int]:
    """The isotope errors whose precursor window holds ``mono``: the
    window of ``expmass - iso * NEUTRON`` in f32, for each ``iso`` of the
    searched range (Sage's ``initial_hits``)."""
    out = []
    for iso in isotopes:
        qm = F32(F32(expmass) - F32(F32(iso) * NEUTRON))
        if in_window(mono, qm, prec_tol):
            out.append(int(iso))
    return out


def isotope_range(sage_cfg: dict) -> List[int]:
    lo, hi = (sage_cfg.get("isotope_errors") or [0, 0])[:2]
    return list(range(int(lo), int(hi) + 1))


def tolerance(obj: dict) -> Tuple[str, float, float]:
    (kind, (lo, hi)), = obj.items()
    return (kind.lower(), float(lo), float(hi))


class SearchJudge:
    """Judges reported PSMs against the reference's own scoring.

    ``feed(spectrum, masses, intens, psm)`` takes one sampled spectrum
    (the generator's record), its processed peaks as the reference
    derives them, and the program's top PSM for it as a dict (display,
    charge, hyperscore, matched_peaks, longest_b, longest_y, calcmass,
    label) or None. ``numbers()`` gives the compared numbers."""

    def __init__(self, sage_cfg: dict):
        self.mods = Mods(sage_cfg["database"])
        self.prec_tol = tolerance(sage_cfg["precursor_tol"])
        self.isotopes = isotope_range(sage_cfg)
        self.frag_tol = tolerance(sage_cfg["fragment_tol"])
        self.max_fz = sage_cfg.get("max_fragment_charge")
        self.judged = 0
        self.missing = 0
        self.wrong = 0
        self.hs_gap = 0.0
        self.ion_gap = 0
        self.mass_gap = 0.0
        self.first_wrong: Optional[str] = None
        # a spectrum's PSM recurs in every table of its batch: score each
        # (spectrum, peptide) once
        self._scores: Dict[tuple, dict] = {}

    def _score(self, spec, pep, masses, intens) -> dict:
        key = (spec.id, pep.seq, pep.var_sites, float(pep.mono))
        if key not in self._scores:
            self._scores[key] = score_peptide(pep, spec.charge, masses, intens,
                                              self.frag_tol, self.max_fz)
        return self._scores[key]

    def _wrong(self, why: str) -> None:
        self.wrong += 1
        if self.first_wrong is None:
            self.first_wrong = why

    def feed(self, spec, masses, intens, psm: Optional[dict],
             ref_score: Optional[dict] = None) -> None:
        """``ref_score``: the features a stand-in for the program
        reported (the control); the program's own PSM otherwise."""
        self.judged += 1
        if psm is None:
            if spec.truth is not None:
                self.missing += 1
            return
        pep = parse_display(psm["display"], self.mods,
                            decoy=bool(psm.get("decoy", False)))
        if pep is None:
            self._wrong(f"{spec.id}: unparseable {psm['display']}")
            return
        if int(psm["charge"]) != spec.charge:
            self._wrong(f"{spec.id}: charge {psm['charge']} != {spec.charge}")
            return
        expmass = precursor_mass(spec.prec_mz, spec.charge)
        isos = isotope_windows(pep.mono, expmass, self.prec_tol, self.isotopes)
        if not isos:
            self._wrong(f"{spec.id}: {psm['display']} outside the window")
            return
        # the isotope error reported is that of a window holding the peptide
        iso_err = float(psm.get("isotope_error", 0.0))
        if not any(iso_err == float(F32(F32(k) * NEUTRON)) for k in isos):
            self._wrong(f"{spec.id}: {psm['display']} isotope error {iso_err}"
                        f", windows {isos}")
            return
        ref = self._score(spec, pep, masses, intens)
        got = ref_score if ref_score is not None else psm
        self.hs_gap = max(self.hs_gap, abs(float(got["hyperscore"])
                                           - ref["hyperscore"]))
        for key in ("matched_peaks", "longest_b", "longest_y"):
            self.ion_gap = max(self.ion_gap, abs(int(got[key]) - ref[key]))
        self.mass_gap = max(self.mass_gap,
                            abs(float(got["calcmass"]) - float(pep.mono)))
        if spec.truth is not None:
            truth = self._score(spec, spec.truth, masses, intens)
            if float(got["hyperscore"]) < truth["hyperscore"] - 1e-9 * max(
                    1.0, truth["hyperscore"]):
                self._wrong(f"{spec.id}: {psm['display']} scores "
                            f"{got['hyperscore']} below the drawn peptide's "
                            f"{truth['hyperscore']}")

    def numbers(self) -> Dict[str, float]:
        return {"missing_psms": float(self.missing),
                "wrong_psms": float(self.wrong),
                "hyperscore_gap": float(self.hs_gap),
                "ion_gap": float(self.ion_gap),
                "calcmass_gap": float(self.mass_gap)}


def control_scores(sage_cfg: dict, spec, masses, intens, psm: dict) -> dict:
    """The control's features for a reported PSM: the reference's scoring
    with its ion ladders rounded to bfloat16."""
    mods = Mods(sage_cfg["database"])
    pep = parse_display(psm["display"], mods, decoy=bool(psm.get("decoy", False)))
    out = score_peptide(pep, spec.charge, masses, intens,
                        tolerance(sage_cfg["fragment_tol"]),
                        sage_cfg.get("max_fragment_charge"), low=True)
    out["calcmass"] = float(bf16(np.array([pep.mono], np.float32))[0])
    return out


def reporter_ions(masses: np.ndarray, intens: np.ndarray, labels,
                  tol: Tuple[str, float, float], low: bool = False) -> List[float]:
    """Sage's ``find_reporter_ions``: for each label m/z, the most
    intense peak (ties to the later) within the tolerance of the label,
    the window shifted by -PROTON because peaks are neutral masses; 0
    where none. ``low``: the intensities rounded to bfloat16 (the
    control)."""
    out = []
    for label in labels:
        lo, hi = tol_bounds(tol[0], tol[1], tol[2], F32(label))
        lo, hi = F32(lo - PROTON), F32(hi - PROTON)
        i = int(np.searchsorted(masses, lo, "left"))
        j = int(np.searchsorted(masses, hi, "right"))
        if j <= i:
            out.append(0.0)
            continue
        seg = intens[i:j]
        best = seg[int(np.flatnonzero(seg == seg.max())[-1])]
        out.append(float(bf16(np.array([best], np.float32))[0]) if low
                   else float(best))
    return out


# ---------------------------------------------------------------------------
# rescoring and FDR


def gauss_solve(a: np.ndarray, b: np.ndarray, dtype=np.float64):
    """Sage's ``Gauss::solve``: Gauss-Jordan elimination (pivot: the
    largest value, not magnitude, ties to the later row; a column whose
    pivot is 0 is skipped) on ``a + eps * I``, retried with eps = 1e-8,
    1e-7, ..., 1 until the left side reduces exactly: diagonal entries 0
    or 1 and no off-diagonal entry above 1e-8. None if no eps does."""
    eps = 1e-8
    while eps <= 1.0:
        x = _gauss_once(a, b, eps, dtype)
        if x is not None:
            return x, eps
        eps *= 10.0
    return None, None


def _gauss_once(a, b, eps, dtype):
    with np.errstate(divide="ignore", invalid="ignore", over="ignore"):
        return _gauss_steps(a, b, eps, dtype)


def _gauss_steps(a, b, eps, dtype):
    left = np.array(a, dtype=dtype)
    right = np.array(b, dtype=dtype).reshape(left.shape[0], -1)
    m, n = left.shape
    left[np.arange(n), np.arange(n)] += dtype(eps)
    h = k = 0
    while h < m and k < n:
        col = left[h:, k]
        piv = h + (col.size - 1 - int(np.argmax(col[::-1])))
        if left[piv, k] == 0.0:
            k += 1
            continue
        if piv != h:
            left[[h, piv]] = left[[piv, h]]
            right[[h, piv]] = right[[piv, h]]
        f = left[h + 1:, k] / left[h, k]
        left[h + 1:, k] = 0.0
        left[h + 1:, k + 1:] -= np.outer(f, left[h, k + 1:])
        right[h + 1:] -= np.outer(f, right[h])
        h += 1
        k += 1
    lead = []
    for i in range(m - 1, -1, -1):
        nz = np.flatnonzero(left[i] != 0.0)
        if nz.size:
            j = int(nz[0])
            x = left[i, j]
            left[i, j:] /= x
            right[i] /= x
            lead.append((i, j))
    for i, j in lead:  # rows from the last up
        if i == 0:
            continue
        f = left[:i, j] / left[i, j]
        left[:i] -= np.outer(f, left[i])
        right[:i] -= np.outer(f, right[i])
    d = np.diag(left)
    off = left - np.diag(d)
    if np.all((d == 0.0) | (d == 1.0)) and not np.any(off > 1e-8):
        return right
    return None


FEATURES = 20


def feature_matrix(c: Dict[str, np.ndarray], mass_pep: np.ndarray,
                   dtype=np.float64) -> np.ndarray:
    """The 20 LDA features (``linear_discriminant.rs``)."""
    f = lambda k: np.asarray(c[k], np.float64)  # noqa: E731
    with np.errstate(divide="ignore", invalid="ignore"):
        poisson = np.log1p(-f("poisson"))
    poisson = np.where(np.isfinite(poisson), poisson, 3.5)
    cols = [
        f("rank"), f("charge"), np.log1p(f("hyperscore")),
        np.log1p(f("delta_next")), np.log1p(f("delta_best")), mass_pep,
        f("isotope_error"), f("average_ppm"), poisson,
        np.log1p(f("matched_intensity_pct")), f("matched_peaks"),
        np.log1p(f("longest_b")), np.log1p(f("longest_y")),
        f("longest_y") / f("peptide_len"), np.log1p(f("peptide_len")),
        f("missed_cleavages"), f("aligned_rt"), f("ims"),
        np.sqrt(np.clip(f("delta_rt_model"), 0.001, 0.999)),
        np.sqrt(np.clip(f("delta_ims_model"), 0.001, 0.999)),
    ]
    return np.stack(cols, axis=1).astype(dtype)


def kde_pep(scores: np.ndarray, decoy: np.ndarray, bins: int,
            bw_scale: float, monotonic: bool, dtype=np.float64):
    """Sage's ``kde.rs`` estimator: Gaussian KDEs of decoys and targets
    (bandwidth ``sigma * (4 / 3n) ** 0.2``, times ``bw_scale``), the
    posterior error ``pi * fd / (pi * fd + (1 - pi) * ft)`` on ``bins``
    evenly spaced scores, monotone by a reverse running max if asked,
    read by linear interpolation. Returns the function of a score."""
    s = np.asarray(scores, dtype)
    d, t = s[decoy], s[~decoy]
    pi = d.size / max(s.size, 1)

    def density(sample, xs):
        if sample.size == 0:
            return np.zeros_like(xs)
        sigma = np.sqrt(np.sum((sample - np.mean(sample)) ** 2) / sample.size)
        h = dtype(sigma * (4.0 / 3.0 / sample.size) ** 0.2 * bw_scale)
        if not np.isfinite(h) or h == 0:
            return np.zeros_like(xs)
        acc = np.zeros_like(xs)
        step = max(1, int(4e6 // max(xs.size, 1)))
        for a in range(0, sample.size, step):
            z = (xs[:, None] - sample[None, a:a + step]) / h
            acc += np.exp(-0.5 * z * z).sum(axis=1)
        return acc / (np.sqrt(dtype(2.0 * np.pi)) * h * sample.size)

    lo = dtype(s.min()) if s.size else dtype(0.0)
    hi = dtype(s.max()) if s.size else dtype(1.0)
    step = (hi - lo) / dtype(max(bins - 1, 1))
    xs = (np.arange(bins, dtype=dtype) * step + lo).astype(dtype)
    fd = density(d, xs) * dtype(pi)
    ft = density(t, xs) * dtype(1.0 - pi)
    with np.errstate(invalid="ignore", divide="ignore"):
        pep = fd / (ft + fd)
    if monotonic:
        pep = np.maximum.accumulate(pep[::-1])[::-1]

    def at(x):
        x = np.asarray(x, dtype)
        with np.errstate(invalid="ignore", divide="ignore"):
            rel = np.floor((x - lo) / step)
        rel = np.where(np.isnan(rel), 0.0, rel)
        b0 = np.clip(rel, 0, bins - 1).astype(np.int64)
        b1 = np.minimum(bins - 1, b0 + 1)
        with np.errstate(invalid="ignore", divide="ignore"):
            frac = (x - (b0 * step + lo)) / step
        return pep[b0] + (pep[b1] - pep[b0]) * frac

    return at


def q_values(decoy_sorted: np.ndarray) -> np.ndarray:
    """Target-decoy q-values of PSMs sorted by score, best first
    (``qvalue.rs``): (1 + decoys) / targets in f32, then a reverse
    running minimum from 1."""
    d = F32(1.0) + np.cumsum(decoy_sorted).astype(np.float32)
    t = np.cumsum(~decoy_sorted).astype(np.float32)
    with np.errstate(divide="ignore", invalid="ignore"):
        q = (d / t).astype(np.float32)
    out = np.fmin.accumulate(np.r_[F32(1.0), q[::-1]])[1:][::-1]
    return out.astype(np.float32)


def picked_q(keys: List, scores: np.ndarray, decoy: np.ndarray,
             dtype=np.float64) -> Dict:
    """Picked target-decoy competition (``fdr.rs``): the best target and
    best decoy score per key, a monotone KDE on each key's winner, decoys
    estimated as 1 + the running sum of posterior errors. Returns
    {(key, is_decoy): q}."""
    best: Dict = {}
    for k, s, dec in zip(keys, scores, decoy):
        fwd, rev = best.get(k, (None, None))
        if dec:
            rev = s if rev is None else max(rev, s)
        else:
            fwd = s if fwd is None else max(fwd, s)
        best[k] = (fwd, rev)
    lowest = np.finfo(np.float32).min
    groups = list(best.items())
    win = np.array([max(f if f is not None else lowest,
                        r if r is not None else lowest) for _, (f, r) in groups])
    win_dec = np.array([(r if r is not None else lowest)
                        >= (f if f is not None else lowest)
                        for _, (f, r) in groups])
    pep_at = kde_pep(win.astype(np.float64), win_dec, 1000, 1.0, True, dtype)
    entries = []
    for k, (f, r) in groups:
        if f is not None:
            entries.append(((k, False), F32(f), False))
        if r is not None:
            entries.append(((k, True), F32(r), True))
    sc = np.array([e[1] for e in entries], np.float32)
    dec = np.array([e[2] for e in entries], bool)
    order = np.argsort(-sc, kind="stable")
    pep = pep_at(sc[order].astype(np.float64)).astype(np.float32)
    dsum = F32(1.0) + np.cumsum(pep, dtype=np.float32)
    tsum = np.cumsum(~dec[order]).astype(np.float32)
    with np.errstate(divide="ignore", invalid="ignore"):
        q = (dsum / tsum).astype(np.float32)
    q = np.fmin.accumulate(np.r_[F32(1.0), q[::-1]])[1:][::-1]
    return {entries[o][0]: float(q[i]) for i, o in enumerate(order)}


def lda_order(c: Dict[str, np.ndarray], predict_rt: bool) -> np.ndarray:
    """The order in which the engine hands its PSMs to the discriminant:
    by PSM id (file, batch, row), then, where RT prediction runs, stably
    by Poisson score (``runner.rs`` sorts them so to train the RT model)."""
    o = np.argsort(np.asarray(c["psm_id"]), kind="stable")
    if predict_rt:
        o = o[np.argsort(np.asarray(c["poisson"])[o], kind="stable")]
    return o


def lda_candidates(c: Dict[str, np.ndarray], prec_tol, predict_rt: bool,
                   low: bool = False) -> List[dict]:
    """Sage's discriminant summed in several orders of the PSMs: the
    engine's (:func:`lda_order`), its reverse, by PSM id, and as given.

    Sage sums the class means and the scatter in parallel, in no fixed
    order. Where the scatter is near-singular, the eps that Gauss-Jordan's
    retry accepts (exact 0 / 1 diagonal, off-diagonal at most 1e-8) turns
    on that rounding, and with it the discriminant: each order's answer
    is Sage's. Each item holds ``disc``, ``pep``, ``eps``, ``order`` and
    the order's ``name``, its arrays in the given order of ``c``; None
    where the fit fails."""
    n = len(np.asarray(c["label"]))
    engine = lda_order(c, predict_rt)
    orders = {"engine": engine, "reverse": engine[::-1],
              "psm_id": np.argsort(np.asarray(c["psm_id"]), kind="stable"),
              "given": np.arange(n)}
    out = []
    for name, o in orders.items():
        r = lda_scores({k: np.asarray(v)[o] for k, v in c.items()},
                       prec_tol, low=low)
        if r is None:
            out.append(None)
            continue
        back = np.empty(n, np.int64)
        back[o] = np.arange(n)
        out.append({"disc": r["disc"][back], "pep": r["pep"][back],
                    "eps": r["eps"], "order": o, "name": name})
    return out


def lda_scores(c: Dict[str, np.ndarray], prec_tol: Tuple[str, float, float],
               low: bool = False):
    """The discriminant and log10 posterior error of every PSM, summed in
    the given row order, or None where the fit fails. ``low``: float32
    throughout."""
    dt = np.float32 if low else np.float64
    decoy = np.asarray(c["label"]) == -1
    kind, lo, hi = prec_tol
    if kind == "ppm":
        err = np.asarray(c["delta_mass"], np.float64)
        bw, bins = 2.0, max(hi - lo, 100.0)
    else:
        err = (np.asarray(c["expmass"], np.float32)
               - np.asarray(c["calcmass"], np.float32)).astype(np.float64)
        bw, bins = 0.1, max(hi - lo, 1000.0)
    mass_at = kde_pep(err, decoy, int(abs(math.ceil(bins))), bw, False, dt)
    x = feature_matrix(c, mass_at(err).astype(np.float64), dt)
    nd, nt = int(decoy.sum()), int((~decoy).sum())
    if nd == 0 or nt == 0:
        return None
    # class sums row after row, in the order the PSMs are given
    mu_d = x[decoy].sum(axis=0, dtype=dt) / dt(nd)
    mu_t = x[~decoy].sum(axis=0, dtype=dt) / dt(nt)
    cd = x[decoy] - mu_d
    ct = x[~decoy] - mu_t
    sw = (cd.T @ cd) / dt(nd) + (ct.T @ ct) / dt(nt)
    coef, eps = gauss_solve(sw, mu_t - mu_d, dt)
    if coef is None or not np.all(np.isfinite(coef)):
        return None
    disc = (x @ coef[:, 0]).astype(np.float64)
    pep_at = kde_pep(disc, decoy, 1000, 1.0, True, dt)
    with np.errstate(divide="ignore", invalid="ignore"):
        pep = np.log10(pep_at(disc).astype(np.float64))
    disc32 = disc.astype(np.float32).astype(np.float64)
    pep32 = pep.astype(np.float32).astype(np.float64)
    return {"disc": disc32, "pep": np.where(np.isinf(pep32), -324.0, pep32),
            "coef": coef[:, 0], "eps": eps}


def heuristic_scores(c: Dict[str, np.ndarray]) -> dict:
    """Sage's fallback where the discriminant cannot be fitted
    (``runner.rs``): ``ln(1 - poisson) + longest_y_pct / 3`` in f32, and
    no posterior error (it stays 1)."""
    with np.errstate(divide="ignore", invalid="ignore"):
        a = np.log1p(-np.asarray(c["poisson"], np.float64)).astype(np.float32)
    b = np.asarray(c["longest_y_pct"], np.float32) / F32(3.0)
    disc = (a + b).astype(np.float32).astype(np.float64)
    return {"disc": disc, "pep": np.ones(disc.size), "coef": None,
            "eps": None}


class Proteins:
    """The proteome's targets: each digested sequence's proteins."""

    def __init__(self, proteins: Sequence[Tuple[str, str]], enzyme_cfg: dict):
        enz = Enzyme(enzyme_cfg)
        self.of: Dict[str, List[str]] = {}
        for acc, seq in proteins:
            for s, e, _ in enz.spans(seq):
                lst = self.of.setdefault(seq[s:e], [])
                if not lst or lst[-1] != acc:
                    lst.append(acc)


def reverse_interior(seq: str) -> str:
    return seq[0] + seq[1:-1][::-1] + seq[-1] if len(seq) > 2 else seq
