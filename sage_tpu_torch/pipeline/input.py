"""Search configuration: JSON -> fully-defaulted Search parameters.

Reference: crates/sage-cli/src/input.rs — an Options-everywhere Input
deserialized from one JSON file, CLI overrides for fasta/mzml/output and
flags, validation warnings, and the `build()` defaulting step
(input.rs:286-386).
"""

from __future__ import annotations

import dataclasses
import json
import logging
import os
import sys
from typing import List, Optional

from ..chem.mass import Tolerance
from ..index.builder import DatabaseParams
from ..quant.tmt import Isobaric

log = logging.getLogger("sage_tpu_torch")


@dataclasses.dataclass
class LfqSettings:
    """lfq.rs:26-68 defaults via input.rs LfqOptions."""

    peak_scoring: str = "Hybrid"
    integration: str = "Sum"
    spectral_angle: float = 0.7
    ppm_tolerance: float = 5.0
    mobility_pct_tolerance: float = 1.0
    combine_charge_states: bool = True
    peptide_q_value: float = 0.01

    @staticmethod
    def from_json(v: Optional[dict]) -> "LfqSettings":
        v = v or {}
        d = LfqSettings()
        s = LfqSettings(
            peak_scoring=v.get("peak_scoring") or d.peak_scoring,
            integration=v.get("integration") or d.integration,
            spectral_angle=abs(v.get("spectral_angle", d.spectral_angle)),
            ppm_tolerance=abs(v.get("ppm_tolerance", d.ppm_tolerance)),
            mobility_pct_tolerance=v.get(
                "mobility_pct_tolerance", d.mobility_pct_tolerance
            ),
            combine_charge_states=v.get(
                "combine_charge_states", d.combine_charge_states
            ),
            peptide_q_value=v.get("peptide_q_value", d.peptide_q_value),
        )
        if s.ppm_tolerance > 20.0:
            log.warning("lfq_settings.ppm_tolerance is higher than expected")
        if s.mobility_pct_tolerance > 4.0:
            log.warning("lfq_settings.mobility_pct_tolerance is higher than expected")
        if s.mobility_pct_tolerance < 0.05:
            log.warning("lfq_settings.mobility_pct_tolerance is smaller than expected")
        if s.spectral_angle < 0.50:
            log.warning("lfq_settings.spectral_angle is lower than expected")
        return s


@dataclasses.dataclass
class TmtSettings:
    level: int = 3
    sn: bool = False

    @staticmethod
    def from_json(v: Optional[dict]) -> "TmtSettings":
        v = v or {}
        return TmtSettings(level=v.get("level", 3), sn=v.get("sn", False))


@dataclasses.dataclass
class QuantSettings:
    tmt: Optional[Isobaric] = None
    tmt_settings: TmtSettings = dataclasses.field(default_factory=TmtSettings)
    lfq: bool = False
    lfq_settings: LfqSettings = dataclasses.field(default_factory=LfqSettings)

    @staticmethod
    def from_json(v: Optional[dict]) -> "QuantSettings":
        v = v or {}
        return QuantSettings(
            tmt=Isobaric.from_json(v["tmt"]) if v.get("tmt") is not None else None,
            tmt_settings=TmtSettings.from_json(v.get("tmt_settings")),
            lfq=bool(v.get("lfq") or False),
            lfq_settings=LfqSettings.from_json(v.get("lfq_settings")),
        )


@dataclasses.dataclass
class Search:
    """Fully-defaulted search parameters (input.rs:16-53, 286-386)."""

    database: DatabaseParams
    precursor_tol: Tolerance
    fragment_tol: Tolerance
    quant: QuantSettings = dataclasses.field(default_factory=QuantSettings)
    precursor_charge: tuple = (2, 4)
    override_precursor_charge: bool = False
    isotope_errors: tuple = (0, 0)
    deisotope: bool = True
    chimera: bool = False
    wide_window: bool = False
    min_peaks: int = 15
    max_peaks: int = 150
    max_fragment_charge: Optional[int] = None
    min_matched_peaks: int = 4
    report_psms: int = 1
    predict_rt: bool = True
    mzml_paths: List[str] = dataclasses.field(default_factory=list)
    output_directory: str = "."
    write_pin: bool = False
    write_report: bool = False
    annotate_matches: bool = False
    parquet: bool = False
    protein_grouping: bool = True
    protein_grouping_peptide_fdr: float = 0.01
    score_type: str = "SageHyperScore"
    bruker_config: Optional[dict] = None
    # Extensions with no reference analog: the device-mesh shape (data,
    # model) of a multi-device search — None = one device, or every
    # visible card along "data" — and the number of
    # files read concurrently (main.rs:118-121's --batch-size; 0 =
    # num_cpus/2).
    mesh_shape: Optional[tuple] = None
    batch_size: int = 0
    version: str = "0.1.0"
    output_paths: List[str] = dataclasses.field(default_factory=list)

    def to_json_dict(self) -> dict:
        """The resolved-parameters record echoed to stdout and
        results.json (runner.rs:666-671)."""
        d = self.database
        return {
            "version": self.version,
            "database": {
                "bucket_size": d.bucket_size,
                "enzyme": d.enzyme,
                "peptide_min_mass": d.peptide_min_mass,
                "peptide_max_mass": d.peptide_max_mass,
                "ion_kinds": list(d.ion_kinds),
                "min_ion_index": d.min_ion_index,
                "static_mods": {str(k): v for k, v in d.static_mods.items()},
                "variable_mods": {
                    str(k): list(v) for k, v in d.variable_mods.items()
                },
                "max_variable_mods": d.max_variable_mods,
                "decoy_tag": d.decoy_tag,
                "generate_decoys": d.generate_decoys,
                "fasta": d.fasta,
            },
            "quant": {
                "tmt": self.quant.tmt.kind if self.quant.tmt else None,
                "tmt_settings": dataclasses.asdict(self.quant.tmt_settings),
                "lfq": self.quant.lfq,
                "lfq_settings": dataclasses.asdict(self.quant.lfq_settings),
            },
            "precursor_tol": self.precursor_tol.to_json(),
            "fragment_tol": self.fragment_tol.to_json(),
            "precursor_charge": list(self.precursor_charge),
            "override_precursor_charge": self.override_precursor_charge,
            "isotope_errors": list(self.isotope_errors),
            "deisotope": self.deisotope,
            "chimera": self.chimera,
            "wide_window": self.wide_window,
            "min_peaks": self.min_peaks,
            "max_peaks": self.max_peaks,
            "max_fragment_charge": self.max_fragment_charge,
            "min_matched_peaks": self.min_matched_peaks,
            "report_psms": self.report_psms,
            "predict_rt": self.predict_rt,
            "mzml_paths": list(self.mzml_paths),
            "output_paths": list(self.output_paths),
            "protein_grouping": self.protein_grouping,
            "protein_grouping_peptide_fdr": self.protein_grouping_peptide_fdr,
            "score_type": self.score_type,
            **(
                {"mesh_shape": list(self.mesh_shape)}
                if self.mesh_shape is not None else {}
            ),
        }


def _check_mass_tolerance(tol: Tolerance) -> None:
    """input.rs:252-284 warnings."""
    lo, hi = tol.lo, tol.hi
    if tol.kind == "pct":
        log.warning(
            "Pct tolerances are very rarely used for mass tolerances, did you mean ppm?"
        )
    if abs(hi) > abs(lo):
        log.warning(
            "Tolerances are applied to experimental masses, not theoretical: [%s, %s]",
            lo, hi,
        )
    if lo > 0.0:
        log.warning(
            "The `left` tolerance should probably be negative, for example: [%s, %s]",
            -lo, abs(hi),
        )
    if hi < 0.0:
        log.warning(
            "The `right` tolerance should probably be positive, for example: [%s, %s]",
            -abs(lo), hi,
        )


def load_config(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def build_search(
    cfg: dict,
    fasta: Optional[str] = None,
    mzml_paths: Optional[List[str]] = None,
    output_directory: Optional[str] = None,
    write_pin: Optional[bool] = None,
    write_report: Optional[bool] = None,
    annotate_matches: Optional[bool] = None,
    parquet: Optional[bool] = None,
    mesh_shape: Optional[tuple] = None,
    batch_size: Optional[int] = None,
) -> Search:
    """Input::build with CLI overrides (input.rs:199-246, 286-386)."""
    dbcfg = dict(cfg.get("database") or {})
    if fasta is not None:
        dbcfg["fasta"] = fasta
    if not dbcfg.get("fasta"):
        raise ValueError("`database.fasta` must be set")
    paths = mzml_paths if mzml_paths else cfg.get("mzml_paths")
    if not paths:
        raise ValueError("`mzml_paths` must be set")

    precursor_tol = Tolerance.from_json(cfg["precursor_tol"])
    fragment_tol = Tolerance.from_json(cfg["fragment_tol"])
    _check_mass_tolerance(fragment_tol)
    _check_mass_tolerance(precursor_tol)

    iso = cfg.get("isotope_errors")
    if iso and iso[0] > iso[1]:
        log.error(
            "Minimum isotope_error value greater than maximum! "
            "Typical usage: `isotope_errors: [-1, 3]`"
        )
        sys.exit(1)
    charges = cfg.get("precursor_charge")
    if charges and charges[0] > charges[1]:
        log.error(
            "Precursor charges should be specified [low, high], "
            "user provided: [%s, %s]", charges[0], charges[1],
        )
        sys.exit(1)

    quant = QuantSettings.from_json(cfg.get("quant"))
    predict_rt = cfg.get("predict_rt")
    if predict_rt is False and quant.lfq:
        log.warning(
            "`predict_rt: false` and `lfq: true` are incompatible. "
            "Setting `predict_rt: true`"
        )
        predict_rt = True

    out_dir = output_directory or cfg.get("output_directory") or "."
    os.makedirs(out_dir, exist_ok=True)

    def flag(name, override, default=False):
        if override is not None:
            return override
        v = cfg.get(name)
        return default if v is None else bool(v)

    return Search(
        database=DatabaseParams.from_config(dbcfg),
        precursor_tol=precursor_tol,
        fragment_tol=fragment_tol,
        quant=quant,
        precursor_charge=tuple(charges) if charges else (2, 4),
        override_precursor_charge=bool(cfg.get("override_precursor_charge") or False),
        isotope_errors=tuple(iso) if iso else (0, 0),
        deisotope=cfg.get("deisotope", True) if cfg.get("deisotope") is not None else True,
        chimera=bool(cfg.get("chimera") or False),
        wide_window=bool(cfg.get("wide_window") or False),
        min_peaks=cfg.get("min_peaks") or 15,
        max_peaks=cfg.get("max_peaks") or 150,
        max_fragment_charge=cfg.get("max_fragment_charge"),
        min_matched_peaks=cfg.get("min_matched_peaks", 4)
        if cfg.get("min_matched_peaks") is not None
        else 4,
        report_psms=cfg.get("report_psms") or 1,
        predict_rt=predict_rt if predict_rt is not None else True,
        mzml_paths=list(paths),
        output_directory=out_dir,
        write_pin=flag("write_pin", write_pin),
        write_report=flag("write_report", write_report),
        annotate_matches=flag("annotate_matches", annotate_matches),
        parquet=flag("parquet", parquet),
        protein_grouping=cfg.get("protein_grouping", True)
        if cfg.get("protein_grouping") is not None
        else True,
        protein_grouping_peptide_fdr=cfg.get("protein_grouping_peptide_fdr") or 0.01,
        score_type=cfg.get("score_type") or "SageHyperScore",
        bruker_config=cfg.get("bruker_config"),
        mesh_shape=tuple(mesh_shape)
        if mesh_shape is not None
        else (tuple(cfg["mesh_shape"]) if cfg.get("mesh_shape") else None),
        batch_size=batch_size
        if batch_size is not None
        else int(cfg.get("batch_size") or 0),
    )
