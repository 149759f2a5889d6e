"""Label-free quantification: FlashLFQ-style direct ion-current extraction.

Reference: crates/sage/src/lfq.rs — build an RT-binned MS1 "feature map"
(mirror of the fragment index: PrecursorRanges sorted by RT, 16384-wide
bins re-sorted by mass, per-bin min RT) from confident peptides x
charges x 3 isotopes plus decoy ranges at +11.06 Da / RT - 2*tol.
Every MS1 peak scatters into per-precursor Grid matrices
[files x isotopes, 100 RT bins] with linear interpolation; traces are
smoothed (gaussian kernel sigma=0.5, len 10), scored by normalized
spectral angle vs the theoretical isotope envelope, time-warped against
the reference run (+-75 bins), peak-picked (hybrid score
SA^3 * rt^0.33 * sqrt(I/max)) and integrated within 50%-threshold
boundaries.
"""

from __future__ import annotations

import dataclasses
import logging
from typing import Dict, List, Optional, Tuple

import numpy as np

from ..chem.isotopes import peptide_isotopes
from ..chem.mass import (
    COMPOSITION_CARBON,
    COMPOSITION_SULFUR,
    NEUTRON,
    Tolerance,
)
from ..fdr import picked_precursor
from ..index.builder import IndexedDatabase, binary_search_slice
from ..ml.retention_alignment import Alignment
from ..ops.features import FeatureTable
from ..pipeline.input import LfqSettings
from ..spectrum.processor import ProcessedSpectrum

log = logging.getLogger("sage_tpu_torch")

RT_TOL = np.float32(0.0050)
K_WIDTH = 10
GRID_SIZE = 100
N_ISOTOPES = 3
BIN_SIZE = 16 * 1024

F32 = np.float32


@dataclasses.dataclass
class Peak:
    """lfq.rs:330-341."""

    rt: int = 0
    spectral_angle: float = 0.0
    score: float = 0.0
    q_value: float = 1.0


@dataclasses.dataclass
class FeatureMap:
    """Columnar PrecursorRange arrays, RT-bucketed then mass-sorted
    within buckets (lfq.rs:86-193)."""

    rt: np.ndarray  # f32 [N]
    mass_lo: np.ndarray
    mass_hi: np.ndarray
    mobility_lo: np.ndarray
    mobility_hi: np.ndarray
    charge: np.ndarray  # u8
    isotope: np.ndarray  # i32
    peptide: np.ndarray  # i32
    file_id: np.ndarray  # i32
    decoy: np.ndarray  # bool
    min_rts: np.ndarray  # f32 per bucket
    settings: LfqSettings

    def quantify(
        self,
        db: IndexedDatabase,
        spectra: List[ProcessedSpectrum],
        alignments: List[Alignment],
    ) -> Dict[Tuple, Tuple[Peak, List[float]]]:
        return _quantify(self, db, spectra, alignments)


def build_feature_map(
    settings: LfqSettings,
    precursor_charge: Tuple[int, int],
    db: IndexedDatabase,
    features: FeatureTable,
) -> FeatureMap:
    """lfq.rs:94-193. ``features`` must be sorted by confidence (the
    runner sorts by discriminant score descending before calling)."""
    c = features.columns
    sel = (c["peptide_q"] <= settings.peptide_q_value) & (c["label"] == 1)
    idx = np.flatnonzero(sel)
    # first (most confident) entry per peptide
    pep = c["peptide_idx"][idx]
    _, first = np.unique(pep, return_index=True)
    idx = idx[first]

    base_rt = c["aligned_rt"][idx].astype(np.float32)
    base_mass = c["calcmass"][idx].astype(np.float32)
    base_file = c["file_id"][idx]
    base_pep = c["peptide_idx"][idx]
    ims_tol = Tolerance(
        "pct", -settings.mobility_pct_tolerance, settings.mobility_pct_tolerance
    )
    mob_lo, mob_hi = ims_tol.bounds(c["ims"][idx].astype(np.float32))

    charges = np.arange(precursor_charge[0], precursor_charge[1] + 1, dtype=np.int32)
    isotopes = np.arange(N_ISOTOPES, dtype=np.int32)
    ppm = Tolerance("ppm", -settings.ppm_tolerance, settings.ppm_tolerance)

    n = idx.size
    nc = charges.size
    ni = isotopes.size
    # broadcast [n, nc, ni]
    mass = (
        base_mass[:, None, None] + isotopes[None, None, :].astype(np.float32) * NEUTRON
    ) / charges[None, :, None].astype(np.float32)
    mass = mass.astype(np.float32)
    lo_f, hi_f = ppm.bounds(mass)
    lo_r, hi_r = ppm.bounds((mass + F32(11.06)).astype(np.float32))

    def tile(x):
        return np.broadcast_to(x[:, None, None], (n, nc, ni)).reshape(-1)

    fwd_rt = tile(base_rt)
    rev_rt = np.maximum(fwd_rt - RT_TOL * F32(2.0), F32(0.0))

    rt = np.concatenate([fwd_rt, rev_rt])
    mass_lo = np.concatenate([lo_f.reshape(-1), lo_r.reshape(-1)])
    mass_hi = np.concatenate([hi_f.reshape(-1), hi_r.reshape(-1)])
    mobility_lo = np.concatenate([tile(mob_lo)] * 2)
    mobility_hi = np.concatenate([tile(mob_hi)] * 2)
    charge = np.concatenate(
        [np.broadcast_to(charges[None, :, None], (n, nc, ni)).reshape(-1)] * 2
    )
    isotope = np.concatenate(
        [np.broadcast_to(isotopes[None, None, :], (n, nc, ni)).reshape(-1)] * 2
    )
    peptide = np.concatenate([tile(base_pep)] * 2)
    file_id = np.concatenate([tile(base_file)] * 2)
    decoy = np.concatenate(
        [np.zeros(n * nc * ni, bool), np.ones(n * nc * ni, bool)]
    )

    # RT sort, then per-bucket mass sort with recorded bucket min RT
    order = np.argsort(rt, kind="stable")
    arrs = dict(
        rt=rt[order], mass_lo=mass_lo[order], mass_hi=mass_hi[order],
        mobility_lo=mobility_lo[order], mobility_hi=mobility_hi[order],
        charge=charge[order], isotope=isotope[order], peptide=peptide[order],
        file_id=file_id[order], decoy=decoy[order],
    )
    total = rt.size
    n_buckets = (total + BIN_SIZE - 1) // BIN_SIZE
    min_rts = np.empty(max(n_buckets, 0), dtype=np.float32)
    for b in range(n_buckets):
        sl = slice(b * BIN_SIZE, min((b + 1) * BIN_SIZE, total))
        min_rts[b] = arrs["rt"][sl][0]
        inner = np.argsort(arrs["mass_lo"][sl], kind="stable")
        for k in arrs:
            arrs[k][sl] = arrs[k][sl][inner]

    return FeatureMap(min_rts=min_rts, settings=settings, **arrs)


def _convolve_same(rows: np.ndarray, kernel: np.ndarray) -> np.ndarray:
    """The reference's convolve (lfq.rs:633-649) for each row of a 2D
    array. With the even-length symmetric kernel this equals the full
    correlation sampled at q = idx+4 for idx < 5 and q = idx+5 after."""
    klen = kernel.size
    n = klen - klen // 2
    L = rows.shape[-1]
    out = np.empty_like(rows)
    # window start index: max(idx-(n-1), 0); kernel start: max(klen-n-idx, 0)
    # -> correlation offset i = idx-n for idx < n, idx-(n-1) after; in the
    # zero-padded full correlation (q = i + klen - 1) that is q = idx+klen-1-n
    # for the first n outputs and q = idx+klen-n afterwards.
    lead = klen - 1 - n  # 4 for klen=10
    for r in range(rows.shape[0]):
        full = np.correlate(rows[r], kernel, mode="full")
        out[r, :n] = full[lead : lead + n]
        out[r, n:] = full[lead + n + 1 : lead + n + 1 + L - n]
    return out


def _gaussian_kernel(sigma: float, length: int) -> np.ndarray:
    step = 2.0 / (length - 1)
    x = np.arange(length) * step - 1.0
    k = np.exp(-0.5 * (x / sigma) ** 2) / (sigma * np.sqrt(2.0 * np.pi))
    return k / k.sum()


class Grid:
    """lfq.rs:513-611."""

    def __init__(self, rt: float, file_id: int, distribution, n_files: int):
        self.rt_min = F32(rt - RT_TOL)
        self.rt_step = F32(RT_TOL * F32(2.0) / F32(GRID_SIZE))
        self.files = n_files
        self.reference_file_id = int(file_id)
        self.distribution = np.asarray(distribution, dtype=np.float32)
        self.matrix = np.zeros((n_files * N_ISOTOPES, GRID_SIZE), dtype=np.float64)

    def add_entries(self, rts, isotopes, file_ids, intensities):
        """Vectorized add_entry (lfq.rs:538-550)."""
        rel = (np.asarray(rts, np.float32) - self.rt_min) / self.rt_step
        with np.errstate(invalid="ignore"):
            fl = np.floor(rel)
        fl = np.where(np.isnan(fl), 0.0, fl)
        bin_lo = np.clip(fl, 0, GRID_SIZE - 1).astype(np.int64)
        bin_hi = np.minimum(bin_lo + 1, GRID_SIZE - 1)
        bin_lo_rt = bin_lo.astype(np.float32) * self.rt_step + self.rt_min
        interp = (np.asarray(rts, np.float32) - bin_lo_rt) / self.rt_step
        row = np.asarray(file_ids, np.int64) * N_ISOTOPES + np.asarray(
            isotopes, np.int64
        )
        w_lo = ((F32(1.0) - interp) * intensities).astype(np.float64)
        w_hi = (interp * intensities).astype(np.float64)
        np.add.at(self.matrix, (row, bin_lo), w_lo)
        np.add.at(self.matrix, (row, bin_hi), w_hi)

    def summarize_traces(self) -> "Traces":
        k = _gaussian_kernel(0.5, K_WIDTH)
        nf = self.files
        sa = np.zeros((nf, GRID_SIZE), dtype=np.float64)
        dot = np.zeros((nf, GRID_SIZE), dtype=np.float64)
        ss_dist = float(np.sqrt(np.sum(self.distribution.astype(np.float64) ** 2)))
        for f in range(nf):
            rows = self.matrix[f * N_ISOTOPES : (f + 1) * N_ISOTOPES]
            conv = _convolve_same(rows, k)
            self.matrix[f * N_ISOTOPES : (f + 1) * N_ISOTOPES] = conv
            d = (conv * self.distribution[:, None].astype(np.float64)).sum(axis=0)
            ss = (conv**2).sum(axis=0)
            with np.errstate(invalid="ignore", divide="ignore"):
                sim = np.where(ss > 0, d / (np.sqrt(ss) * ss_dist), 0.0)
                # no clamp: sim > 1 from fp rounding yields NaN, as in the
                # reference's f64::acos (lfq.rs:600)
                sa[f] = 1.0 - 2.0 * np.arccos(sim) / np.pi
            dot[f] = d
        return Traces(dot, sa, self.reference_file_id)


class Traces:
    """lfq.rs:324-509."""

    def __init__(self, dot_product, spectral_angle, reference_file_id):
        self.dot_product = dot_product  # [files, GRID_SIZE]
        self.spectral_angle = spectral_angle
        self.reference_file_id = reference_file_id

    def find_time_warps(self, matrix: np.ndarray, slack: int) -> np.ndarray:
        ref = matrix[self.reference_file_id]
        L = matrix.shape[1]
        offsets = np.zeros(matrix.shape[0], dtype=np.int64)
        for row in range(matrix.shape[0]):
            run = matrix[row]
            best = (0, 0.0)
            for off in range(-slack, slack + 1):
                j0 = max(0, -off)
                j1 = min(L, L - off)
                dot = float(np.dot(ref[j0:j1], run[j0 + off : j1 + off]))
                if dot >= best[1]:
                    best = (off, dot)
            offsets[row] = best[0]
        return offsets

    @staticmethod
    def _apply_time_warps(matrix: np.ndarray, warps: np.ndarray) -> None:
        L = matrix.shape[1]
        for row, w in enumerate(warps):
            shifted = np.zeros(L, dtype=matrix.dtype)
            j0 = max(0, -w)
            j1 = min(L, L - w)
            shifted[j0:j1] = matrix[row, j0 + w : j1 + w]
            matrix[row] = shifted

    def warp(self) -> None:
        warps = self.find_time_warps(self.dot_product, 75)
        self._apply_time_warps(self.spectral_angle, warps)
        self._apply_time_warps(self.dot_product, warps)

    def scores(self, strategy: str) -> Tuple[np.ndarray, np.ndarray]:
        summed = 1.0 + self.dot_product.sum(axis=0)  # [GRID_SIZE]
        weighted = (self.spectral_angle * self.dot_product).sum(axis=0)
        spectral = weighted / summed
        intensity = summed
        mx = intensity.max()
        cols = self.spectral_angle.shape[1]
        center = cols // 2
        rtv = np.arange(cols, dtype=np.float64)
        rt_term = 1.0 - np.abs(rtv - center) / center
        if strategy == "RetentionTime":
            scores = rt_term**0.33
        elif strategy == "SpectralAngle":
            scores = spectral.copy()
        elif strategy == "Intensity":
            scores = np.sqrt(intensity / mx)
        else:  # Hybrid
            with np.errstate(invalid="ignore"):
                scores = spectral**3 * rt_term**0.33 * np.sqrt(intensity / mx)
        return scores, spectral

    def integrate(self, settings: LfqSettings) -> Optional[Tuple[Peak, List[float]]]:
        """lfq.rs:447-509."""
        self.warp()
        scores, spectral = self.scores(settings.peak_scoring)
        best = Peak()
        for rt in range(scores.size):
            if scores[rt] > best.score and spectral[rt] >= settings.spectral_angle:
                best.score = float(scores[rt])
                best.rt = rt
        if best.score == 0.0:
            return None

        left = max(best.rt - 1, 0)
        right = best.rt + 1
        threshold = best.score * 0.50
        lo_bound = max(best.rt - scores.size // 5, 0)
        while (
            left > lo_bound
            and scores[left] >= threshold
            and spectral[left] >= settings.spectral_angle
        ):
            left -= 1
        hi_bound = min(max(scores.size - 1, 0), best.rt + 20)
        while (
            right < hi_bound
            and scores[right] >= threshold
            and spectral[right] >= settings.spectral_angle
        ):
            right += 1

        areas = []
        for f in range(self.dot_product.shape[0]):
            if settings.integration == "Apex":
                areas.append(float(self.dot_product[f, best.rt]))
            else:
                areas.append(float(self.dot_product[f, left:right].sum()))

        summed = 1.0 + float(self.dot_product[:, best.rt].sum())
        weighted = float(
            (self.spectral_angle[:, best.rt] * self.dot_product[:, best.rt]).sum()
        )
        best.spectral_angle = weighted / summed
        return best, areas


def _quantify(
    fmap: FeatureMap,
    db: IndexedDatabase,
    spectra: List[ProcessedSpectrum],
    alignments: List[Alignment],
) -> Dict[Tuple, Tuple[Peak, List[float]]]:
    """lfq.rs:226-305."""
    settings = fmap.settings
    n_files = len(alignments)
    grids: Dict[Tuple, Grid] = {}
    # peptide -> isotope distribution, computed lazily
    dist_cache: Dict[int, np.ndarray] = {}

    log.info("tracing MS1 features")
    if not spectra:
        log.warning("no MS1 spectra found for quantification")

    for spectrum in spectra:
        a = alignments[spectrum.file_id]
        rt = F32(
            F32(F32(spectrum.scan_start_time) / F32(a.max_rt)) * F32(a.slope)
            + F32(a.intercept)
        )
        lo_b, hi_b = binary_search_slice(fmap.min_rts, rt - RT_TOL, rt + RT_TOL)
        if hi_b <= lo_b:
            continue
        masses = spectrum.masses
        intens = spectrum.intensities
        mob = spectrum.mobilities
        has_mob = mob.size > 0
        n_total = fmap.rt.size
        for b in range(lo_b, hi_b):
            s = b * BIN_SIZE
            e = min(s + BIN_SIZE, n_total)
            sl_lo = fmap.mass_lo[s:e]
            # candidate windows per peak
            i0 = np.searchsorted(sl_lo, masses - F32(0.1), side="left")
            i0 = np.maximum(i0 - 1, 0)
            i1 = np.searchsorted(sl_lo, masses + F32(0.1), side="right")
            i1 = np.maximum(i1, i0)
            counts = i1 - i0
            if counts.sum() == 0:
                continue
            pk = np.repeat(np.arange(masses.size), counts)
            offs = np.arange(counts.sum()) - np.repeat(
                np.cumsum(counts) - counts, counts
            )
            ridx = np.repeat(i0, counts) + offs + s
            m = masses[pk]
            ok = (
                (fmap.rt[ridx] <= rt + RT_TOL)
                & (fmap.rt[ridx] >= rt - RT_TOL)
                & (m >= fmap.mass_lo[ridx])
                & (m <= fmap.mass_hi[ridx])
            )
            if has_mob:
                mo = mob[pk]
                ok &= (fmap.mobility_hi[ridx] >= mo) & (fmap.mobility_lo[ridx] <= mo)
            if not ok.any():
                continue
            ridx = ridx[ok]
            pk = pk[ok]
            for j in range(ridx.size):
                ri = int(ridx[j])
                pep = int(fmap.peptide[ri])
                dec = bool(fmap.decoy[ri])
                if settings.combine_charge_states:
                    key = (pep, dec)
                else:
                    key = ((pep, int(fmap.charge[ri])), dec)
                grid = grids.get(key)
                if grid is None:
                    dist = dist_cache.get(pep)
                    if dist is None:
                        res = db.table.residues[pep]
                        L = int(db.table.lens[pep])
                        aa = res[:L].astype(np.int64) - 65
                        aa = np.clip(aa, 0, 25)
                        carbon = int(COMPOSITION_CARBON[aa].sum())
                        sulfur = int(COMPOSITION_SULFUR[aa].sum())
                        dist = peptide_isotopes(carbon, sulfur)
                        dist_cache[pep] = dist
                    grid = Grid(
                        float(fmap.rt[ri]), int(fmap.file_id[ri]), dist, n_files
                    )
                    grids[key] = grid
                grid.add_entries(
                    [float(rt)],
                    [int(fmap.isotope[ri])],
                    [spectrum.file_id],
                    [float(intens[pk[j]])],
                )

    log.info("integrating MS1 features")
    out: Dict[Tuple, Tuple[Peak, List[float]]] = {}
    for key, grid in grids.items():
        traces = grid.summarize_traces()
        res = traces.integrate(settings)
        if res is None:
            continue
        out[key] = res
    return out


def assign_precursor_q(areas: Dict[Tuple, Tuple[Peak, List[float]]]) -> int:
    """fdr::picked_precursor applied to the LFQ peak map."""
    if not areas:
        return 0
    keys = list(areas.keys())
    scores = np.array([areas[k][0].score for k in keys], dtype=np.float32)
    decoys = np.array([k[1] for k in keys], dtype=bool)
    q, passing = picked_precursor(scores, decoys)
    for i, k in enumerate(keys):
        areas[k][0].q_value = float(q[i])
    return passing
