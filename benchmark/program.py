"""The harness's call sites into the program under test, ``sage_tpu_torch``.

This is the one module of the benchmark that imports the program. It
hands the program the benchmark's inputs (a FASTA text, spectra as plain
arrays, an mzML path, the configuration's Sage settings) through its
public entry points, and reads back what the program produced: PSM
tables and the Runner's phase seconds.
"""

from __future__ import annotations

from typing import Dict, Iterable, Iterator, List

import numpy as np

import sage_tpu_torch  # noqa: F401  (fails early where the program is absent)
from sage_tpu_torch.chem.fasta import Fasta
from sage_tpu_torch.ops.search import Scorer, SearchParams
from sage_tpu_torch.pipeline.input import build_search
from sage_tpu_torch.pipeline.runner import Runner
from sage_tpu_torch.spectrum.processor import Precursor, ProcessedSpectrum

from .traffic import Spectrum, processed_masses


def search_settings(sage_cfg: dict, fasta_path: str, mzml_paths: List[str],
                    out_dir: str, write_pin: bool = False):
    cfg = dict(sage_cfg)
    return build_search(cfg, fasta=fasta_path, mzml_paths=mzml_paths,
                        output_directory=out_dir, write_pin=write_pin)


def build_database(search, fasta_text: str):
    dbp = search.database
    return dbp.build(Fasta.parse(fasta_text, dbp.decoy_tag,
                                 dbp.generate_decoys))


def make_scorer(search, db, device: str) -> Scorer:
    """The Scorer the Runner would make for these settings."""
    p = search
    return Scorer(db, SearchParams(
        precursor_tol=p.precursor_tol, fragment_tol=p.fragment_tol,
        min_matched_peaks=p.min_matched_peaks,
        min_isotope_err=p.isotope_errors[0],
        max_isotope_err=p.isotope_errors[1],
        min_precursor_charge=p.precursor_charge[0],
        max_precursor_charge=p.precursor_charge[1],
        override_precursor_charge=p.override_precursor_charge,
        max_fragment_charge=p.max_fragment_charge, chimera=p.chimera,
        report_psms=p.report_psms, wide_window=p.wide_window,
        annotate_matches=p.annotate_matches, score_type=p.score_type,
    ), device=device)


def processed(spectra: List[Spectrum], take_top_n: int) -> List[ProcessedSpectrum]:
    """The generator's spectra as processed MS2 spectra (neutral masses
    at charge 1, the top ``take_top_n`` peaks, ascending by mass)."""
    out = []
    for s in spectra:
        mass = processed_masses(s.mz)
        inten = s.intensity
        if mass.size > take_top_n:
            keep = np.lexsort((mass, inten))[::-1][:take_top_n]
            mass, inten = mass[keep], inten[keep]
        order = np.argsort(mass, kind="stable")
        mass, inten = mass[order], inten[order]
        out.append(ProcessedSpectrum(
            level=2, id=s.id, file_id=0, scan_start_time=s.rt,
            ion_injection_time=1.0,
            precursors=[Precursor(mz=s.prec_mz, charge=s.charge)],
            masses=mass, intensities=inten,
            mobilities=np.zeros(0, np.float32),
            total_ion_current=np.float32(inten.sum())))
    return out


def score_stream(scorer: Scorer, batches: Iterable) -> Iterator:
    return scorer.score_stream(batches)


def new_runner(search, device: str) -> Runner:
    return Runner(search, device=device)


def run(runner: Runner) -> dict:
    return runner.run()


_KEPT = ("rank", "spec_idx", "peptide_idx", "charge", "hyperscore",
         "matched_peaks", "longest_b", "longest_y", "calcmass", "label",
         "isotope_error")


def keep(table, fault=None) -> dict:
    """What the judge reads of a FeatureTable the window yielded: its PSM
    columns (array references, no copies and no Python objects, so that
    holding many costs the window nothing). ``fault`` (tests only)
    rewrites the table first."""
    if fault is not None:
        table = fault(table)
    return {k: table.columns[k] for k in _KEPT}


def top_psms(table, db, ids=None, rows=None) -> Dict:
    """Each spectrum's rank-1 PSM of a FeatureTable, by spectrum id (only
    those of ``ids`` where given), or of a kept table (:func:`keep`), by
    the spectrum's row in its batch (only those of ``rows``)."""
    if rows is not None:
        c, key = table, None
        want = set(int(r) for r in rows)
    else:
        c, key = table.columns, table.spec_ids
    out = {}
    for i in np.flatnonzero(c["rank"] == 1):
        r = int(c["spec_idx"][i])
        sid = key[r] if key is not None else r
        if (ids is not None and sid not in ids) or (rows is not None and r not in want):
            continue
        pep = db.peptides[int(c["peptide_idx"][i])]
        out[sid] = {
            "display": str(pep),
            "decoy": bool(pep.decoy),
            "charge": int(c["charge"][i]),
            "hyperscore": float(c["hyperscore"][i]),
            "matched_peaks": int(c["matched_peaks"][i]),
            "longest_b": int(c["longest_b"][i]),
            "longest_y": int(c["longest_y"][i]),
            "calcmass": float(c["calcmass"][i]),
            "label": int(c["label"][i]),
            "isotope_error": float(c["isotope_error"][i]),
        }
    return out


def displays(table, db) -> List[str]:
    """The display string of every row's peptide."""
    return [str(db.peptides[int(i)]) for i in table.columns["peptide_idx"]]


def settings_top_n(search) -> int:
    return int(search.max_peaks)


def runner_database(runner: Runner):
    return runner.database
