"""The pipeline's runner: database build, batched search, rescoring, FDR,
quant, outputs.

Reference: crates/sage-cli/src/runner.rs — Runner::new builds the
database from FASTA (with optional prefilter), Runner::run batches mzML
files, searches each batch, then runs RT alignment + RT/IM prediction,
LDA rescoring, spectrum/peptide/protein/protein-group FDR, protein
grouping, TMT and label-free quant, and writes every output artifact.

Counterpart of ``sage_tpu/pipeline/runner.py``: spectra are scored in
large padded batches on one CUDA device (``ops/search.py``) and PSMs
accumulate in a columnar FeatureTable. A multi-process run
(``parallel/multihost.py``) gives each process a shard of the files and
a card of its own, or one it shares; the results are gathered before
the global stages and process 0 writes the outputs. A mesh shape, or a
process that sees more than one card, searches on a ("data", "model")
grid of devices (``parallel/sharding.py``).
"""

from __future__ import annotations

import gzip
import logging
import os
import time
from typing import List, Optional, Tuple

import numpy as np
import torch

from .. import fdr as fdr_mod
from .. import protein_grouping
from ..chem.fasta import Fasta
from ..chem.mass import Tolerance
from ..ml import lda, mobility_model, qvalue, retention_alignment, retention_model
from ..ops.features import FeatureTable
from ..ops.search import Scorer, SearchParams
from ..parallel.multihost import (
    gather_file_results, maybe_init_distributed, shard_paths,
)
from ..quant import tmt as tmt_mod
from ..spectrum.processor import ProcessedSpectrum, SpectrumProcessor
from ..utils import trace
from .input import Search
from .output import OutputWriter

log = logging.getLogger("sage_tpu_torch")

# device batch size for spectrum scoring: big enough to amortize the
# per-batch host work and launches while the merge grid (batch x K
# candidate rescore) stays well inside device memory
SCORE_BATCH = int(os.environ.get("SAGE_TPU_SCORE_BATCH", "8192"))


def read_fasta(path: str, decoy_tag: str, generate_decoys: bool) -> Fasta:
    if path.endswith(".gz"):
        with gzip.open(path, "rt") as f:
            contents = f.read()
    else:
        with open(path) as f:
            contents = f.read()
    return Fasta.parse(contents, decoy_tag, generate_decoys)


# the port's hand kernels, by the name of their launch counters
KERNELS = ("stage1_counts", "row_sort", "cluster_sort", "rescore",
           "peak_ranges", "open_entries", "open_count", "batch_prep")

# Runner.phases' keys, each the ``run.<phase>`` span's seconds
PHASES = ("db_build", "read", "process", "search", "rt_ml", "fdr", "lda",
          "quant", "write")


def _kernel_launches() -> dict:
    """Each hand kernel's launches in this process so far."""
    c = trace.counters()
    return {k: c.get("launch." + k, 0) for k in KERNELS}


class Runner:
    """``device``: where the search runs. Defaults to ``"cuda"``; with no
    CUDA device the caller must pass ``"cpu"`` explicitly (the plain
    versions of every kernel then run). In a multi-process run a process
    with no ``device`` takes ``cuda:$LOCAL_RANK`` when LOCAL_RANK is set,
    else ``cuda:{process_id % device_count}``, so that processes spread
    over the cards or share one."""

    def __init__(self, parameters: Search, device=None):
        # the process group forms before any work starts
        self.process_id, self.process_count = maybe_init_distributed()
        if device is None:
            if not torch.cuda.is_available():
                raise RuntimeError(
                    "Runner: no CUDA device is available; pass device='cpu' "
                    "to run the plain versions on the CPU"
                )
            device = "cuda"
            if self.process_count > 1:
                local = os.environ.get("LOCAL_RANK")
                index = (int(local) if local is not None else
                         self.process_id % torch.cuda.device_count())
                device = f"cuda:{index}"
                torch.cuda.set_device(index)
        self.device = torch.device(device)
        self.parameters = parameters
        self.start = time.monotonic()
        # the recorder's totals when this Runner began: its phases are
        # the run.* spans' growth since (Runners of a process run one
        # at a time)
        self._phase_base = trace.totals()
        db_params = parameters.database
        fasta = read_fasta(db_params.fasta, db_params.decoy_tag, db_params.generate_decoys)
        with trace.span("run.db_build") as build:
            if db_params.prefilter:
                # prefilter mode handled during batch search
                # (runner.rs:104-127)
                self.database = None
                self._fasta = fasta
            else:
                self.database = db_params.build(fasta)
                self._fasta = None
        log.info(
            "generated %d fragments, %d peptides in %dms",
            self.database.num_fragments if self.database else 0,
            len(self.database) if self.database else 0,
            build.ns // 1_000_000,
        )

    @property
    def phases(self) -> dict:
        """Per-phase wall seconds of this Runner so far (the analog of
        the reference's per-phase ms logs, runner.rs:476-477, 673-674):
        each ``run.<phase>`` span's total, ``lda_s`` a part of ``fdr_s``;
        ``gather_s`` in a multi-process run. Returned from run() and
        logged at the end so the gap between kernel throughput and
        pipeline throughput is always attributed."""
        now = trace.totals()
        keys = PHASES + (("gather",) if self.process_count > 1 else ())
        return {k + "_s": now.get("run." + k, 0.0)
                - self._phase_base.get("run." + k, 0.0) for k in keys}

    # ------------------------------------------------------------------

    def search_params(self) -> SearchParams:
        p = self.parameters
        return SearchParams(
            precursor_tol=p.precursor_tol,
            fragment_tol=p.fragment_tol,
            min_matched_peaks=p.min_matched_peaks,
            min_isotope_err=p.isotope_errors[0],
            max_isotope_err=p.isotope_errors[1],
            min_precursor_charge=p.precursor_charge[0],
            max_precursor_charge=p.precursor_charge[1],
            override_precursor_charge=p.override_precursor_charge,
            max_fragment_charge=p.max_fragment_charge,
            chimera=p.chimera,
            report_psms=p.report_psms,
            wide_window=p.wide_window,
            annotate_matches=p.annotate_matches,
            score_type=p.score_type,
        )

    def _spectrum_processor(self) -> SpectrumProcessor:
        p = self.parameters
        min_deisotope_mz = 0.0
        if p.quant.tmt is not None and p.quant.tmt_settings.level == 2:
            masses = p.quant.tmt.reporter_masses()
            if len(masses):
                min_deisotope_mz = float(masses[-1] * (1.0 + 20e-6))
        return SpectrumProcessor(
            take_top_n=p.max_peaks,
            deisotope=p.deisotope,
            min_deisotope_mz=min_deisotope_mz,
        )

    def read_file(self, path: str, file_id: int) -> List[ProcessedSpectrum]:
        """Format-dispatched spectrum reading + processing (util.rs:59-72,
        runner.rs:377-480)."""
        from ..io.cloudpath import read_spectra

        p = self.parameters
        sn_level = p.quant.tmt_settings.level if p.quant.tmt_settings.sn else None
        sp = self._spectrum_processor()
        with trace.span("run.read"):
            raw = read_spectra(
                path,
                file_id=file_id,
                signal_to_noise=sn_level,
                requires_ms1=bool(p.quant.lfq),
                bruker_config=p.bruker_config,
            )
        with trace.span("run.process"):
            return [sp.process(s) for s in raw]

    def process_file(
        self, scorer: Scorer, path: str, file_id: int, spectra=None
    ) -> Tuple[FeatureTable, list, list]:
        """Read, search and TMT-quantify one file (process_chunk,
        runner.rs:365-375); returns its PSMs, TMT quant and, for LFQ, its
        MS1 spectra."""
        p = self.parameters
        t0 = time.monotonic()
        if spectra is None:
            spectra = self.read_file(path, file_id)
        log.info("- file IO: %8d ms", int((time.monotonic() - t0) * 1000))

        ms2 = [
            s for s in spectra if s.level == 2 and len(s) >= p.min_peaks
        ]
        with trace.span("run.search") as search:
            batches = [ms2[i : i + SCORE_BATCH] for i in range(0, len(ms2), SCORE_BATCH)]
            tables = list(scorer.score_stream(batches))
            features = FeatureTable.concat(tables) if tables else FeatureTable.empty()
        dt = search.ns / 1e9
        log.info(
            "- search:  %8d ms (%d spectra/s)",
            int(dt * 1000),
            int(len(ms2) / dt) if dt > 0 else 0,
        )

        quant = []
        if p.quant.tmt is not None:
            level = p.quant.tmt_settings.level
            if level != 2 and level != 3:
                log.warning("TMT quant level set at %d, is this correct?", level)
            with trace.span("run.quant"):
                quant = tmt_mod.quantify(
                    spectra, p.quant.tmt, Tolerance("ppm", -20.0, 20.0), level
                )

        ms1 = [s for s in spectra if s.level == 1] if p.quant.lfq else []
        return features, quant, ms1

    # ------------------------------------------------------------------

    def _prefilter_database(self):
        """Low-memory giant-database mode (runner.rs:143-240 +
        scoring.rs:255-298): digest the FASTA in chunks, quick-score every
        MS2 scan against each chunk's mini-database, keep only matched
        peptides, then build the final index from the union.

        prefilter_low_memory=True mirrors the reference's full-rescore
        retention (top report_psms per spectrum with >= min_matched_peaks);
        False keeps every preliminary top-K candidate.

        Memory is bounded like the reference's (runner.rs:144-151): all
        files' MS2 spectra are held in RAM only while their estimated
        footprint stays under SAGE_TPU_PREFILTER_RAM_MB (default 4096);
        past that the loop flips to chunk-major with per-file re-reads,
        holding O(one file) of spectra at a time — prefilter exists
        precisely for machines where memory is the constraint."""
        from ..index.builder import reorder_peptides

        p = self.parameters
        dbp = p.database
        fasta = self._fasta
        chunk_size = dbp.auto_prefilter_chunk_size(fasta)
        log.info("prefilter chunk size: %d proteins", chunk_size)

        budget = int(
            os.environ.get("SAGE_TPU_PREFILTER_RAM_MB", "4096")
        ) << 20

        def spectra_bytes(specs):
            return sum(
                s.masses.nbytes + s.intensities.nbytes
                + getattr(s.mobilities, "nbytes", 0) + 512
                for s in specs
            )

        def read_ms2(path, file_id):
            spectra = self.read_file(path, file_id)
            return [
                s for s in spectra
                if s.level == 2 and len(s) >= p.min_peaks
            ]

        ms2: Optional[list] = []
        used = 0
        for file_id, path in enumerate(p.mzml_paths):
            batch = read_ms2(path, file_id)
            used += spectra_bytes(batch)
            if used > budget:
                log.info(
                    "prefilter spectra exceed %d MiB; re-reading files "
                    "per FASTA chunk (low-memory mode)", budget >> 20,
                )
                ms2 = None  # chunk-major re-read mode
                break
            ms2.extend(batch)

        kept = []
        sp = self.search_params()
        for sub in fasta.iter_chunks(chunk_size):
            mini = dbp.build(sub)
            if not len(mini):
                continue
            scorer = Scorer(mini, sp, device=self.device)
            keep_idx = set()

            def score_into(keep_idx, spectra_list, scorer=scorer):
                batches = [
                    spectra_list[i : i + SCORE_BATCH]
                    for i in range(0, len(spectra_list), SCORE_BATCH)
                ]
                if dbp.prefilter_low_memory:
                    for t in scorer.score_stream(batches):
                        keep_idx.update(
                            int(i) for i in t.columns["peptide_idx"]
                        )
                else:
                    for batch in batches:
                        prelim = scorer._preliminary(batch)
                        keep_idx.update(int(i) for i in prelim["cand_pep"])

            if ms2 is not None:
                score_into(keep_idx, ms2)
            else:
                for file_id, path in enumerate(p.mzml_paths):
                    score_into(keep_idx, read_ms2(path, file_id))
            kept.extend(mini.peptides[i] for i in sorted(keep_idx))
            log.info(
                "- prefilter chunk: kept %d/%d peptides", len(keep_idx), len(mini)
            )

        reorder_peptides(kept)
        db = dbp.build_from_peptides(kept)
        log.info(
            "prefiltered database: %d peptides, %d fragments",
            len(db), db.num_fragments,
        )
        return db

    def _make_scorer(self):
        """Single-device or multi-device scorer. The grid is the search's
        engine whenever this process sees more than one device (the
        analog of the reference wiring its rayon pool globally,
        main.rs:107-116): auto shape = (n_devices data, 1 model),
        overridable via the `mesh_shape: [data, model]` config key, the
        `--mesh-shape` CLI flag, or the SAGE_TPU_MESH env var
        ("data,model"; "1,1" forces the single-device path). In a
        multi-process run each process meshes its own device only; a
        shape that needs more devices than the process has fails."""
        from ..parallel import sharding

        p = self.parameters
        shape = p.mesh_shape
        env = os.environ.get("SAGE_TPU_MESH")
        if env:
            shape = tuple(int(x) for x in env.split(","))
        devices = ([self.device] if self.process_count > 1
                   else sharding.local_devices(self.device))
        if shape is None and len(devices) > 1:
            shape = (len(devices), 1)
        if shape is None or shape[0] * shape[1] <= 1:
            return Scorer(self.database, self.search_params(),
                          device=self.device)
        log.info(
            "multi-device search: mesh = (%d data, %d model) over %d "
            "devices", shape[0], shape[1], len(devices),
        )
        mesh = sharding.make_mesh(shape[0], shape[1], devices=devices)
        return sharding.ShardedScorer(self.database, mesh,
                                      self.search_params())

    def _file_workers(self) -> int:
        """Number of files read/processed concurrently: the --batch-size
        flag / batch_size config key, defaulting to num_cpus/2 like the
        reference (main.rs:118-121), floor 1."""
        n = self.parameters.batch_size
        if n <= 0:
            n = (os.cpu_count() or 1) // 2
        return max(int(n), 1)

    def run(self) -> dict:
        p = self.parameters
        if self.database is None:
            self.database = self._prefilter_database()
        scorer = self._make_scorer()
        launches0 = _kernel_launches()

        # This process's shard of the input files (global file_ids kept);
        # a single-process run sees every file.
        work = shard_paths(p.mzml_paths, self.process_id, self.process_count)
        pieces = []  # (file_id, FeatureTable, tmt_quant, ms1)
        # File-batch parallelism: up to `--batch-size` files are parsed/
        # processed concurrently on worker threads (main.rs:118-121's
        # default num_cpus/2, runner.rs:482-489) while the device searches
        # files in order on this thread — the window both overlaps host
        # I/O with device compute and bounds spectra held in RAM, like the
        # reference's file chunks.
        from concurrent.futures import ThreadPoolExecutor

        n_workers = self._file_workers()
        with ThreadPoolExecutor(max_workers=n_workers) as ex:
            futs = {
                w: ex.submit(self.read_file, path, fid)
                for w, (fid, path) in enumerate(work[:n_workers])
            }
            for w, (file_id, path) in enumerate(work):
                try:
                    spectra = futs.pop(w).result()
                except Exception as e:  # noqa: BLE001
                    # a failed read skips the file (runner.rs:429-438)
                    log.error("error parsing %s: %s", path, e)
                    spectra = None
                nxt = w + n_workers
                if nxt < len(work):
                    futs[nxt] = ex.submit(
                        self.read_file, work[nxt][1], work[nxt][0]
                    )
                if spectra is None:
                    continue
                feats, quant, ms1 = self.process_file(
                    scorer, path, file_id, spectra=spectra
                )
                pieces.append((file_id, feats, quant, ms1))
        launches = {k: v - launches0[k] for k, v in _kernel_launches().items()}
        log.info(
            "kernel launches: %s",
            " ".join(f"{k}={v}" for k, v in launches.items()),
        )
        if self.process_count > 1:
            # Cross-process merge before the global stages (the analog of
            # the reference's parallel SageResults reduce,
            # output.rs:21-41); every process goes on with the same full
            # result set.
            with trace.span("run.gather"):
                pieces = gather_file_results(pieces)
            log.info("gathered %d files' results from %d processes",
                     len(pieces), self.process_count)
        all_quant = [q for _, _, quant, _ in pieces for q in quant]
        all_ms1: List[ProcessedSpectrum] = [
            m for _, _, _, ms1 in pieces for m in ms1
        ]
        features = FeatureTable.concat([t for _, t, _, _ in pieces])
        # Deterministic PSM ids in global (file, batch, row) order: the
        # same for any process count (unlike the reference's racy global
        # counter, scoring.rs:163-166).
        features.columns["psm_id"][:] = np.arange(
            1, len(features) + 1, dtype=np.int64
        )

        alignments = None
        with trace.span("run.rt_ml"):
            if p.predict_rt:
                # Poisson is usually the best single feature; use it to
                # get a confident PSM set for RT model training
                # (runner.rs:513-531)
                order = np.argsort(features.columns["poisson"], kind="stable")
                features = features.select(order)
                q, _ = qvalue.spectrum_q_value(features.columns["label"])
                features.columns["spectrum_q"][:] = q
                alignments = retention_alignment.global_alignment(
                    features, len(p.mzml_paths)
                )
                retention_model.predict(self.database, features)
                mobility_model.predict(self.database, features)

        with trace.span("run.fdr"):
            q_spectrum = self.spectrum_fdr(features)
            q_peptide = fdr_mod.picked_peptide(self.database, features)
            q_protein = fdr_mod.picked_protein(self.database, features)
            protein_grouping.generate_protein_groups(
                self.database,
                features,
                p.protein_grouping,
                p.protein_grouping_peptide_fdr,
            )
            q_protein_group = fdr_mod.picked_protein_group(self.database,
                                                           features)

        filenames = [path.split("/")[-1] for path in p.mzml_paths]

        areas = None
        if p.quant.lfq and alignments is not None:
            from ..quant import lfq as lfq_mod

            log.info("performing LFQ")
            with trace.span("run.quant"):
                feature_map = lfq_mod.build_feature_map(
                    p.quant.lfq_settings, p.precursor_charge, self.database,
                    features,
                )
                areas = feature_map.quantify(self.database, all_ms1,
                                             alignments)
                q_precursor = lfq_mod.assign_precursor_q(areas)
            log.info("discovered %d target MS1 peaks at 5%% FDR", q_precursor)

        log.info(
            "discovered %d target peptide-spectrum matches at 1%% FDR", q_spectrum
        )
        log.info("discovered %d target peptides at 1%% FDR", q_peptide)
        log.info(
            "discovered %d target proteins (supported by proteotypic peptides "
            "only) at 1%% FDR", q_protein,
        )
        log.info(
            "discovered %d target protein groups (supported by proteotypic "
            "peptides only) at 1%% FDR", q_protein_group,
        )

        with trace.span("run.write"):
            if self.process_id == 0:
                self._write_outputs(features, filenames, all_quant, areas)
        run_time = int(time.monotonic() - self.start)
        phases = {k: round(v, 3) for k, v in self.phases.items()}
        log.info(
            "phase seconds: %s",
            " ".join(f"{k[:-2]}={v}" for k, v in phases.items()),
        )
        log.info("finished in %ds", run_time)
        return {
            "features": features,
            "q_spectrum": q_spectrum,
            "q_peptide": q_peptide,
            "q_protein": q_protein,
            "q_protein_group": q_protein_group,
            "lfq": areas,
            "run_time": run_time,
            "phases": phases,
        }

    def _write_outputs(self, features, filenames, all_quant, areas) -> None:
        p = self.parameters
        writer = OutputWriter(self.database, p.output_directory)
        if p.parquet:
            # the parquet set replaces the TSVs (runner.rs:597-640)
            from . import parquet_out

            reporter = None
            n_rep = 0
            if all_quant and p.quant.tmt is not None:
                reporter = {(q.file_id, q.spec_id): q.peaks for q in all_quant}
                n_rep = len(p.quant.tmt.headers())
            out = os.path.join(p.output_directory, "results.sage.parquet")
            p.output_paths.append(
                parquet_out.write_features_parquet(
                    out, self.database, features, filenames,
                    reporter_ions=reporter, n_reporter=n_rep,
                )
            )
            if p.annotate_matches:
                p.output_paths.append(
                    parquet_out.write_fragments_parquet(
                        os.path.join(p.output_directory,
                                     "matched_fragments.sage.parquet"),
                        features,
                    )
                )
            if areas is not None:
                p.output_paths.append(
                    parquet_out.write_lfq_parquet(
                        os.path.join(p.output_directory, "lfq.parquet"),
                        self.database, areas, filenames,
                    )
                )
        else:
            p.output_paths.append(writer.write_features(features, filenames))
            if p.annotate_matches:
                p.output_paths.append(writer.write_fragments(features))
            if all_quant:
                p.output_paths.append(
                    writer.write_tmt(all_quant, p.quant.tmt, filenames)
                )
            if areas is not None:
                p.output_paths.append(writer.write_lfq(areas, filenames))
        if p.write_pin:
            p.output_paths.append(writer.write_pin(features, filenames))
        if p.write_report:
            from .report import render_report

            rp = os.path.join(p.output_directory, "sage.report.html")
            with open(rp, "w") as f:
                f.write(
                    render_report(
                        features, filenames, p.to_json_dict(), areas,
                        version=p.version,
                    )
                )
            p.output_paths.append(rp)
        p.output_paths.append(writer.write_results_json(p.to_json_dict()))

    def spectrum_fdr(self, features: FeatureTable) -> int:
        """runner.rs:280-291: LDA with heuristic fallback, then sort by
        discriminant score and assign spectrum q-values."""
        c = features.columns
        with trace.span("run.lda"):
            fitted = lda.score_psms(features, self.parameters.precursor_tol)
        if fitted is None:
            log.warning(
                "linear model fitting failed, falling back to heuristic "
                "discriminant score"
            )
            heur = np.log1p(-c["poisson"]).astype(np.float32) + (
                c["longest_y_pct"].astype(np.float32) / np.float32(3.0)
            )
            c["discriminant_score"][:] = heur.astype(np.float64)
        order = np.argsort(-c["discriminant_score"], kind="stable")
        _reorder_inplace(features, order)
        q, passing = qvalue.spectrum_q_value(c["label"])
        c["spectrum_q"][:] = q
        return passing


def _reorder_inplace(t: FeatureTable, order: np.ndarray) -> None:
    for k in t.columns:
        t.columns[k] = t.columns[k][order]
    t.protein_groups = [t.protein_groups[i] for i in order]
    t.fragments = [t.fragments[i] for i in order]
