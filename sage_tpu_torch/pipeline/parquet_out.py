"""Parquet output writers (pyarrow backend).

Counterpart of ``sage_tpu/pipeline/parquet_out.py``, host code; schema
parity with crates/sage-cloudpath/src/parquet.rs:

* results.sage.parquet — 45 columns incl. the nested optional
  ``reporter_ion_intensity`` float LIST (parquet.rs:28-83); f64 scores
  are narrowed to f32 exactly as the reference's `as f32` casts
  (parquet.rs:130-253).
* matched_fragments.sage.parquet — one row per annotated fragment
  (parquet.rs:255-412).
* lfq.parquet — long format, one row per (precursor, file) including
  decoys; charge is null for combined-charge-state precursors
  (parquet.rs:414-566).

Compression is ZSTD level 3, matching the reference's WriterProperties.
pyarrow is imported at the first write: without it a parquet run fails
with pyarrow's ``ImportError`` and writes no TSV in its place.
"""

from __future__ import annotations

import logging
from typing import Dict, List, Optional

import numpy as np

from ..index.builder import IndexedDatabase
from ..ops.features import FeatureTable

log = logging.getLogger("sage_tpu_torch")


def _pa():
    import pyarrow

    return pyarrow


def write_features_parquet(
    path: str,
    db: IndexedDatabase,
    t: FeatureTable,
    filenames: List[str],
    reporter_ions: Optional[Dict[int, List[float]]] = None,
    n_reporter: int = 0,
) -> str:
    """results.sage.parquet (parquet.rs:130-253). ``reporter_ions`` maps
    spec_idx -> per-channel intensities when TMT quant ran."""
    pa = _pa()
    import pyarrow.parquet as pq

    c = t.columns
    n = len(t)
    pep_idx = c["peptide_idx"].astype(np.int64)
    peptides = [db.peptides[int(i)] for i in pep_idx]

    def pepstr(p):
        return str(p)

    reporter = None
    if n_reporter:
        reporter = []
        for i in range(n):
            key = (int(c["file_id"][i]), t.spec_ids[int(c["spec_idx"][i])])
            vals = (reporter_ions or {}).get(key)
            reporter.append(list(vals) if vals is not None else None)

    cols = {
        "psm_id": pa.array(c["psm_id"].astype(np.int64), pa.int64()),
        "filename": pa.array(
            [filenames[int(i)] for i in c["file_id"]], pa.string()
        ),
        "scannr": pa.array(
            [t.spec_ids[int(i)] for i in c["spec_idx"]], pa.string()
        ),
        "peptide": pa.array([pepstr(p) for p in peptides], pa.string()),
        "stripped_peptide": pa.array(
            [p.sequence.decode() for p in peptides], pa.string()
        ),
        "proteins": pa.array(
            [
                p.proteins_str(db.decoy_tag, db.generate_decoys)
                for p in peptides
            ],
            pa.string(),
        ),
        "protein_groups": pa.array(
            [g or "" for g in t.protein_groups], pa.string()
        ),
        "num_proteins": pa.array(
            [len(p.proteins) for p in peptides], pa.int32()
        ),
        "num_protein_groups": pa.array(
            c["num_protein_groups"].astype(np.int32), pa.int32()
        ),
        "rank": pa.array(c["rank"].astype(np.int32), pa.int32()),
        "is_decoy": pa.array(c["label"] == -1, pa.bool_()),
        "expmass": pa.array(c["expmass"].astype(np.float32), pa.float32()),
        "calcmass": pa.array(c["calcmass"].astype(np.float32), pa.float32()),
        "charge": pa.array(c["charge"].astype(np.int32), pa.int32()),
        "peptide_len": pa.array(c["peptide_len"].astype(np.int32), pa.int32()),
        "missed_cleavages": pa.array(
            c["missed_cleavages"].astype(np.int32), pa.int32()
        ),
        "semi_enzymatic": pa.array(
            [bool(p.semi_enzymatic) for p in peptides], pa.bool_()
        ),
        "ms2_intensity": pa.array(
            c["ms2_intensity"].astype(np.float32), pa.float32()
        ),
        "isotope_error": pa.array(
            c["isotope_error"].astype(np.float32), pa.float32()
        ),
        "precursor_ppm": pa.array(
            c["delta_mass"].astype(np.float32), pa.float32()
        ),
        "fragment_ppm": pa.array(
            c["average_ppm"].astype(np.float32), pa.float32()
        ),
        "hyperscore": pa.array(
            c["hyperscore"].astype(np.float32), pa.float32()
        ),
        "delta_next": pa.array(
            c["delta_next"].astype(np.float32), pa.float32()
        ),
        "delta_best": pa.array(
            c["delta_best"].astype(np.float32), pa.float32()
        ),
        "rt": pa.array(c["rt"].astype(np.float32), pa.float32()),
        "aligned_rt": pa.array(c["aligned_rt"].astype(np.float32), pa.float32()),
        "predicted_rt": pa.array(
            c["predicted_rt"].astype(np.float32), pa.float32()
        ),
        "delta_rt_model": pa.array(
            c["delta_rt_model"].astype(np.float32), pa.float32()
        ),
        "ion_mobility": pa.array(c["ims"].astype(np.float32), pa.float32()),
        "predicted_mobility": pa.array(
            c["predicted_ims"].astype(np.float32), pa.float32()
        ),
        "delta_mobility": pa.array(
            c["delta_ims_model"].astype(np.float32), pa.float32()
        ),
        "matched_peaks": pa.array(
            c["matched_peaks"].astype(np.int32), pa.int32()
        ),
        "longest_b": pa.array(c["longest_b"].astype(np.int32), pa.int32()),
        "longest_y": pa.array(c["longest_y"].astype(np.int32), pa.int32()),
        "longest_y_pct": pa.array(
            c["longest_y_pct"].astype(np.float32), pa.float32()
        ),
        "matched_intensity_pct": pa.array(
            c["matched_intensity_pct"].astype(np.float32), pa.float32()
        ),
        "scored_candidates": pa.array(
            c["scored_candidates"].astype(np.int32), pa.int32()
        ),
        "poisson": pa.array(c["poisson"].astype(np.float32), pa.float32()),
        "sage_discriminant_score": pa.array(
            c["discriminant_score"].astype(np.float32), pa.float32()
        ),
        "posterior_error": pa.array(
            c["posterior_error"].astype(np.float32), pa.float32()
        ),
        "spectrum_q": pa.array(c["spectrum_q"].astype(np.float32), pa.float32()),
        "peptide_q": pa.array(c["peptide_q"].astype(np.float32), pa.float32()),
        "protein_q": pa.array(c["protein_q"].astype(np.float32), pa.float32()),
        "protein_group_q": pa.array(
            c["protein_group_q"].astype(np.float32), pa.float32()
        ),
    }
    if reporter is not None:
        cols["reporter_ion_intensity"] = pa.array(
            reporter, pa.list_(pa.float32())
        )
    table = pa.table(cols)
    pq.write_table(table, path, compression="zstd", compression_level=3)
    return path


def write_fragments_parquet(path: str, t: FeatureTable) -> str:
    """matched_fragments.sage.parquet (parquet.rs:255-412)."""
    pa = _pa()
    import pyarrow.parquet as pq

    c = t.columns
    psm, kind, ordinal, charge, mz_exp, mz_cal, inten = [], [], [], [], [], [], []
    for i in range(len(t)):
        fr = t.fragments[i]
        if fr is None:
            continue
        pid = int(c["psm_id"][i])
        for j in range(len(fr.fragment_ordinals)):
            psm.append(pid)
            kind.append(fr.kinds[j])
            ordinal.append(fr.fragment_ordinals[j])
            charge.append(fr.charges[j])
            mz_exp.append(np.float32(fr.mz_experimental[j]))
            mz_cal.append(np.float32(fr.mz_calculated[j]))
            inten.append(np.float32(fr.intensities[j]))
    table = pa.table(
        {
            "psm_id": pa.array(psm, pa.int64()),
            "fragment_type": pa.array(kind, pa.string()),
            "fragment_ordinals": pa.array(ordinal, pa.int32()),
            "fragment_charge": pa.array(charge, pa.int32()),
            "fragment_mz_experimental": pa.array(mz_exp, pa.float32()),
            "fragment_mz_calculated": pa.array(mz_cal, pa.float32()),
            "fragment_intensity": pa.array(inten, pa.float32()),
        }
    )
    pq.write_table(table, path, compression="zstd", compression_level=3)
    return path


def write_lfq_parquet(
    path: str, db: IndexedDatabase, areas, filenames: List[str]
) -> str:
    """lfq.parquet long format (parquet.rs:414-566): one row per
    (precursor, file), decoys included, charge null for combined
    charge states."""
    pa = _pa()
    import pyarrow.parquet as pq

    peptide, stripped, charge, proteins, is_decoy = [], [], [], [], []
    q_value, fname, intensity = [], [], []
    for (pid, decoy), (peak, data) in areas.items():
        if isinstance(pid, tuple):
            pix, z = pid
        else:
            pix, z = pid, None
        pep = db.peptides[int(pix)]
        for idx, v in enumerate(data):
            peptide.append(str(pep))
            stripped.append(pep.sequence.decode())
            charge.append(int(z) if z is not None else None)
            proteins.append(
                pep.proteins_str(db.decoy_tag, db.generate_decoys)
            )
            is_decoy.append(bool(decoy))
            q_value.append(np.float32(peak.q_value))
            fname.append(filenames[idx])
            intensity.append(np.float32(v))
    table = pa.table(
        {
            "peptide": pa.array(peptide, pa.string()),
            "stripped_peptide": pa.array(stripped, pa.string()),
            "charge": pa.array(charge, pa.int32()),
            "proteins": pa.array(proteins, pa.string()),
            "is_decoy": pa.array(is_decoy, pa.bool_()),
            "q_value": pa.array(q_value, pa.float32()),
            "filename": pa.array(fname, pa.string()),
            "intensity": pa.array(intensity, pa.float32()),
        }
    )
    pq.write_table(table, path, compression="zstd", compression_level=3)
    return path
