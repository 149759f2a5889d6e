"""Global retention-time alignment (DART-ID style).

Reference: crates/sage/src/ml/retention_alignment.rs — normalize RT by
per-file max (ceil, u32), take the per-(peptide, file) MIN rt of
confident PSMs (the reference's `mean_rt_by_file` actually keeps the
minimum, retention_alignment.rs:50-56), average across files per
peptide, then per-file linear regression against the global mean;
``aligned_rt = (rt / max_rt) * slope + intercept`` in f32.
"""

from __future__ import annotations

import dataclasses
import logging
from typing import List

import numpy as np

from ..ops.features import FeatureTable

log = logging.getLogger("sage_tpu_torch")


@dataclasses.dataclass
class Alignment:
    file_id: int
    max_rt: float  # f32
    slope: float  # f32
    intercept: float  # f32


def global_alignment(t: FeatureTable, n_files: int) -> List[Alignment]:
    c = t.columns
    file_id = c["file_id"]
    rt = c["rt"]

    # per-file max RT: fetch_max of rt.ceil() as u32
    max_rt = np.zeros(n_files, dtype=np.float64)
    ceil_rt = np.ceil(rt).astype(np.uint32)
    np.maximum.at(max_rt, file_id, ceil_rt)

    # confident PSMs -> per (peptide, file) MIN rt
    conf = (c["label"] == 1) & (c["spectrum_q"] <= 0.01)
    pep = c["peptide_idx"][conf].astype(np.int64)
    fid = file_id[conf].astype(np.int64)
    prt = rt[conf].astype(np.float64)

    # group by (pep, file): min rt
    if pep.size:
        key = pep * n_files + fid
        order = np.argsort(key, kind="stable")
        key_s = key[order]
        rt_s = prt[order]
        starts = np.r_[0, np.flatnonzero(np.diff(key_s)) + 1]
        min_rt = np.minimum.reduceat(rt_s, starts)
        upep = key_s[starts] // n_files
        ufid = key_s[starts] % n_files
        norm_rt = min_rt / max_rt[ufid]

        # per-peptide mean across files, filter non-normal means
        pstarts = np.r_[0, np.flatnonzero(np.diff(upep)) + 1]
        pcounts = np.diff(np.r_[pstarts, upep.size])
        psum = np.add.reduceat(norm_rt, pstarts)
        pmean = psum / pcounts
        normal = np.isfinite(pmean) & (pmean != 0.0)
        # expand peptide mean back onto (pep, file) entries
        entry_mean = np.repeat(pmean, pcounts)
        entry_keep = np.repeat(normal, pcounts)
        ufid = ufid[entry_keep]
        x = norm_rt[entry_keep]  # per-file normalized rt
        y = entry_mean[entry_keep]  # global mean rt of the peptide
    else:
        ufid = np.zeros(0, dtype=np.int64)
        x = np.zeros(0, dtype=np.float64)
        y = np.zeros(0, dtype=np.float64)

    alignments: List[Alignment] = []
    slopes = np.ones(n_files, dtype=np.float32)
    inters = np.zeros(n_files, dtype=np.float32)
    for f in range(n_files):
        sel = ufid == f
        xs, ys = x[sel], y[sel]
        n = xs.size
        dot = float((xs * ys).sum())
        sum_x = float(xs.sum())
        sum_y = float(ys.sum())
        x_mean = sum_x / n if n else float("nan")
        y_mean = sum_y / n if n else float("nan")
        ssxy = dot - n * x_mean * y_mean
        sx2 = 1e-8 + (float(((xs - x_mean) ** 2).sum()) if n else 0.0)
        slope = ssxy / sx2
        intercept = y_mean - slope * x_mean
        if not np.isfinite(slope):
            slope = 1.0
        if not np.isfinite(intercept):
            intercept = 0.0
        log.info("aligning file #%d: y = %.4fx + %.4f", f, slope, intercept)
        slopes[f] = np.float32(slope)
        inters[f] = np.float32(intercept)
        alignments.append(
            Alignment(
                file_id=f,
                max_rt=float(np.float32(max_rt[f])),
                slope=float(slope),
                intercept=float(intercept),
            )
        )

    # aligned_rt = (rt / max_rt) * slope + intercept, f32 ops
    mx = max_rt.astype(np.float32)[file_id]
    with np.errstate(divide="ignore", invalid="ignore"):
        c["aligned_rt"][:] = (
            (rt / mx).astype(np.float32) * slopes[file_id] + inters[file_id]
        ).astype(np.float32)
    return alignments
