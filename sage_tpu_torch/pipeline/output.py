"""Output writers: results.sage.tsv (43-column contract), matched
fragments TSV, percolator .pin, tmt.tsv, lfq.tsv, results.json.

Reference: crates/sage-cli/src/runner.rs:841-1240. Float formatting
matches the reference's ryu shortest-roundtrip output: numpy's str() for
f32 fields, Python repr() for f64 fields.
"""

from __future__ import annotations

import json
import os
import re
from typing import List, Optional

import numpy as np

from ..index.builder import IndexedDatabase
from ..ops.features import FeatureTable

_SCAN_RE = re.compile(r"scan=(\d+)")


def f32s(v) -> str:
    return str(np.float32(v))


def f64s(v) -> str:
    return repr(float(v))


def _scannr(spec_id: str) -> str:
    caps = _SCAN_RE.findall(spec_id)
    return caps[-1] if caps else spec_id


class OutputWriter:
    def __init__(self, db: IndexedDatabase, output_directory: str):
        self.db = db
        self.dir = output_directory
        # cache per-peptide strings
        self._pep_str = {}
        self._prot_str = {}

    def _path(self, name: str) -> str:
        return os.path.join(self.dir, name)

    def _peptide(self, pi: int) -> str:
        s = self._pep_str.get(pi)
        if s is None:
            s = str(self.db.peptides[pi])
            self._pep_str[pi] = s
        return s

    def _proteins(self, pi: int) -> str:
        s = self._prot_str.get(pi)
        if s is None:
            s = self.db.peptides[pi].proteins_str(
                self.db.decoy_tag, self.db.generate_decoys
            )
            self._prot_str[pi] = s
        return s

    # ------------------------------------------------------------------

    FEATURE_HEADERS = [
        "psm_id", "peptide", "proteins", "protein_groups", "num_proteins",
        "num_protein_groups", "filename", "scannr", "rank", "label",
        "expmass", "calcmass", "charge", "peptide_len", "missed_cleavages",
        "semi_enzymatic", "isotope_error", "precursor_ppm", "fragment_ppm",
        "hyperscore", "delta_next", "delta_best", "rt", "aligned_rt",
        "predicted_rt", "delta_rt_model", "ion_mobility", "predicted_mobility",
        "delta_mobility", "matched_peaks", "longest_b", "longest_y",
        "longest_y_pct", "matched_intensity_pct", "scored_candidates",
        "poisson", "sage_discriminant_score", "posterior_error", "spectrum_q",
        "peptide_q", "protein_q", "protein_group_q", "ms2_intensity",
    ]

    def write_features(self, t: FeatureTable, filenames: List[str]) -> str:
        """results.sage.tsv (runner.rs:694-899)."""
        path = self._path("results.sage.tsv")
        c = t.columns
        db = self.db
        with open(path, "w") as f:
            f.write("\t".join(self.FEATURE_HEADERS) + "\n")
            for i in range(len(t)):
                pi = int(c["peptide_idx"][i])
                pep = db.peptides[pi]
                row = [
                    str(int(c["psm_id"][i])),
                    self._peptide(pi),
                    self._proteins(pi),
                    t.protein_groups[i] or "",
                    str(len(pep.proteins)),
                    str(int(c["num_protein_groups"][i])),
                    filenames[int(c["file_id"][i])],
                    t.spec_ids[int(c["spec_idx"][i])],
                    str(int(c["rank"][i])),
                    str(int(c["label"][i])),
                    f32s(c["expmass"][i]),
                    f32s(c["calcmass"][i]),
                    str(int(c["charge"][i])),
                    str(int(c["peptide_len"][i])),
                    str(int(c["missed_cleavages"][i])),
                    str(int(pep.semi_enzymatic)),
                    f32s(c["isotope_error"][i]),
                    f32s(c["delta_mass"][i]),
                    f32s(c["average_ppm"][i]),
                    f64s(c["hyperscore"][i]),
                    f64s(c["delta_next"][i]),
                    f64s(c["delta_best"][i]),
                    f32s(c["rt"][i]),
                    f32s(c["aligned_rt"][i]),
                    f32s(c["predicted_rt"][i]),
                    f32s(c["delta_rt_model"][i]),
                    f32s(c["ims"][i]),
                    f32s(c["predicted_ims"][i]),
                    f32s(c["delta_ims_model"][i]),
                    str(int(c["matched_peaks"][i])),
                    str(int(c["longest_b"][i])),
                    str(int(c["longest_y"][i])),
                    f32s(c["longest_y_pct"][i]),
                    f32s(c["matched_intensity_pct"][i]),
                    str(int(c["scored_candidates"][i])),
                    f64s(c["poisson"][i]),
                    f32s(c["discriminant_score"][i]),
                    f32s(c["posterior_error"][i]),
                    f32s(c["spectrum_q"][i]),
                    f32s(c["peptide_q"][i]),
                    f32s(c["protein_q"][i]),
                    f32s(c["protein_group_q"][i]),
                    f32s(c["ms2_intensity"][i]),
                ]
                f.write("\t".join(row) + "\n")
        return path

    def write_fragments(self, t: FeatureTable) -> str:
        """matched_fragments.sage.tsv (runner.rs:904-936)."""
        path = self._path("matched_fragments.sage.tsv")
        c = t.columns
        with open(path, "w") as f:
            f.write(
                "psm_id\tfragment_type\tfragment_ordinals\tfragment_charge\t"
                "fragment_mz_calculated\tfragment_mz_experimental\t"
                "fragment_intensity\n"
            )
            for i in range(len(t)):
                fr = t.fragments[i]
                if fr is None:
                    continue
                psm = int(c["psm_id"][i])
                for j in range(len(fr.fragment_ordinals)):
                    f.write(
                        f"{psm}\t{fr.kinds[j]}\t{fr.fragment_ordinals[j]}\t"
                        f"{fr.charges[j]}\t{f32s(fr.mz_calculated[j])}\t"
                        f"{f32s(fr.mz_experimental[j])}\t"
                        f"{f32s(fr.intensities[j])}\n"
                    )
        return path

    PIN_HEADERS = [
        "SpecId", "Label", "ScanNr", "ExpMass", "CalcMass", "FileName",
        "retentiontime", "ion_mobility", "rank", "z=2", "z=3", "z=4", "z=5",
        "z=6", "z=other", "peptide_len", "missed_cleavages", "semi_enzymatic",
        "isotope_error", "ln(precursor_ppm)", "fragment_ppm", "ln(hyperscore)",
        "ln(delta_next)", "ln(delta_best)", "aligned_rt", "predicted_rt",
        "sqrt(delta_rt_model)", "predicted_mobility", "sqrt(delta_mobility)",
        "matched_peaks", "longest_b", "longest_y", "longest_y_pct",
        "ln(matched_intensity_pct)", "scored_candidates", "ln(-poisson)",
        "posterior_error", "Peptide", "Proteins",
    ]

    def write_pin(self, t: FeatureTable, filenames: List[str]) -> str:
        """results.sage.pin (runner.rs:938-1138)."""
        path = self._path("results.sage.pin")
        c = t.columns
        db = self.db
        with open(path, "w") as f:
            f.write("\t".join(self.PIN_HEADERS) + "\n")
            for i in range(len(t)):
                pi = int(c["peptide_idx"][i])
                pep = db.peptides[pi]
                z = int(c["charge"][i])
                spec_id = t.spec_ids[int(c["spec_idx"][i])]
                row = [
                    str(int(c["psm_id"][i])),
                    str(int(c["label"][i])),
                    _scannr(spec_id),
                    f32s(c["expmass"][i]),
                    f32s(c["calcmass"][i]),
                    filenames[int(c["file_id"][i])],
                    f32s(c["rt"][i]),
                    f32s(c["ims"][i]),
                    str(int(c["rank"][i])),
                    str(int(z == 2)),
                    str(int(z == 3)),
                    str(int(z == 4)),
                    str(int(z == 5)),
                    str(int(z == 6)),
                    str(z if (z < 2 or z > 6) else 0),
                    str(int(c["peptide_len"][i])),
                    str(int(c["missed_cleavages"][i])),
                    str(int(pep.semi_enzymatic)),
                    f32s(c["isotope_error"][i]),
                    f32s(np.log1p(np.abs(np.float32(c["delta_mass"][i])))),
                    f32s(c["average_ppm"][i]),
                    f64s(np.log1p(c["hyperscore"][i])),
                    f64s(np.log1p(c["delta_next"][i])),
                    f64s(np.log1p(c["delta_best"][i])),
                    f32s(c["aligned_rt"][i]),
                    f32s(c["predicted_rt"][i]),
                    f32s(np.sqrt(np.clip(np.float32(c["delta_rt_model"][i]), 0.001, 1.0))),
                    f32s(c["predicted_ims"][i]),
                    f32s(c["delta_ims_model"][i]),
                    str(int(c["matched_peaks"][i])),
                    str(int(c["longest_b"][i])),
                    str(int(c["longest_y"][i])),
                    f32s(c["longest_y_pct"][i]),
                    f32s(np.log1p(np.float32(c["matched_intensity_pct"][i]))),
                    str(int(c["scored_candidates"][i])),
                    f64s(np.log1p(-c["poisson"][i])),
                    f32s(c["posterior_error"][i]),
                    self._peptide(pi),
                    self._proteins(pi),
                ]
                f.write("\t".join(row) + "\n")
        return path

    def write_tmt(self, quant, isobaric, filenames: List[str]) -> str:
        """tmt.tsv (runner.rs:1140-1180)."""
        path = self._path("tmt.tsv")
        with open(path, "w") as f:
            headers = ["filename", "scannr", "ion_injection_time"] + isobaric.headers()
            f.write("\t".join(headers) + "\n")
            for q in quant:
                row = [
                    filenames[q.file_id],
                    q.spec_id,
                    f32s(q.ion_injection_time),
                ] + [f32s(p) for p in q.peaks]
                f.write("\t".join(row) + "\n")
        return path

    def write_lfq(self, areas, filenames: List[str]) -> str:
        """lfq.tsv wide format (runner.rs:1182-1240). ``areas`` is a dict
        {(precursor_id, decoy): (Peak, [intensities per file])}."""
        path = self._path("lfq.tsv")
        with open(path, "w") as f:
            headers = [
                "peptide", "charge", "proteins", "q_value", "score",
                "spectral_angle",
            ] + list(filenames)
            f.write("\t".join(headers) + "\n")
            for (pid, decoy), (peak, data) in areas.items():
                if decoy:
                    continue
                if isinstance(pid, tuple):
                    pix, charge = pid
                else:
                    pix, charge = pid, -1
                row = [
                    self._peptide(int(pix)),
                    str(int(charge)),
                    self._proteins(int(pix)),
                    f32s(peak.q_value),
                    f64s(peak.score),
                    f64s(peak.spectral_angle),
                ] + [f64s(x) for x in data]
                f.write("\t".join(row) + "\n")
        return path

    def write_results_json(self, params_dict: dict) -> str:
        path = self._path("results.json")
        with open(path, "w") as f:
            json.dump(params_dict, f, indent=2)
        return path
