"""Drive the PyTorch port on one CUDA card and check it: the Runner and
the CLI from FASTA, mzML, MGF and Bruker .d files to results.sage.tsv,
the parquet set, lfq.tsv and the HTML report, in one process and in
two, the narrow, banded, chimeric and open searches through the fused
and the two-dispatch paths, and the multi-device grid with its shards
laid on the one card.

Usage (from the repository root, on a machine with an NVIDIA H100):

    python3 chip_smoke.py

Phases, each of which fails the run when it fails (each prints its
seconds):

0. Host packages: whether pyarrow (the parquet writer), zstandard and
   compression.zstd (the .d reader's codecs for compressed frames)
   import. Without pyarrow phase 20 writes TSV and records its parquet
   half as not run.
1. Device: the card's name and power limit; exits non-zero without CUDA.
2. Build: the eight kernel sources (csrc/stage1_counts.cu,
   csrc/row_sort.cu, csrc/cluster_sort.cu, csrc/rescore.cu,
   csrc/peak_ranges.cu, csrc/open_entries.cu, csrc/open_count.cu,
   csrc/batch_prep.cu) with
   nvcc, side by side, printing ptxas's registers / shared-memory / spill
   lines and the build time.
11. Runner at full size (runs right after the build: its database is the
   one every later phase searches): bench.py's database as a FASTA
   (synth_fasta(20000), C+57.0215 static and M+15.9949 variable mods,
   decoys) and an mzML of 16,384 of bench.py's synthetic spectra (2 x
   the Runner's 8192-spectrum batch), written to a temporary directory;
   ``Runner(build_search(config)).run()`` in this process on the card,
   precursor +-20 ppm, fragment +-10 ppm, write_pin on. The stage-1
   and rescore counters are set to 0 just before the run and must be
   > 0 after (as in every phase below that runs the rescore: 3, 6, 11,
   13-17, 20, 22-24). Prints
   the Runner's phase seconds, the search and whole-run spectra/s, the
   PSMs / peptides / proteins at 1% FDR and peak device memory; checks
   results.sage.tsv's header against the OutputWriter's columns.
20. Bruker .d through the Runner (right after phase 11, on its Runner
    and database: its parameters replaced, its phase seconds reset):
    phase 11's 16,384 spectra written by ``synth_tdf`` as a ddaPASEF .d
    (10 precursors a frame, each over 4-12 scans of 2 PASEF frames, an
    MS1 frame before each block, m/z on the TOF calibration's grid,
    type-0 frames), searched with parquet output (TSV without pyarrow).
    The stage-1 counter is set to 0 just before the run and must be > 0
    after; over 0.9 of the PSMs within 20.5 ppm. Prints the TDF reader's
    seconds (read_s), the whole-run and search spectra/s and the PSMs at
    1% FDR. Then the first 512 precursors as their own .d through the
    card Runner and the CPU Runner (a copy of phase 11's on the CPU):
    results.sage.parquet (or .tsv) byte-equal.
21. Two processes on the card: phase 11's spectra as 3 mzML files,
    ``python -m sage_tpu_torch`` twice with SAGE_TPU_COORDINATOR on a
    free localhost port, SAGE_TPU_NUM_PROCS=2 and SAGE_TPU_PROC_ID=0/1
    (gloo; both on cuda:0; each builds its own database), each with a
    time limit, against phase 11's Runner on the same files in this
    process: results.sage.tsv byte-equal, process 1 writes nothing, and
    each process's logged stage-1 launches > 0. Prints the processes'
    seconds, their database builds and the gather's seconds (which
    include the wait for the slower process).
24. The Runner on a grid (right after phase 21, on phase 11's Runner,
    database and mzML): ``mesh_shape`` (2, 2) with the process's device
    list replaced by cuda:0 four times, so ``_make_scorer`` builds a
    ShardedScorer whose four shards share the card. The stage-1 counter
    is set to 0 just before the run and must be > 0 after;
    results.sage.tsv must be byte-equal to phase 11's.
3. Narrow main path at full width: bench.py's workload (the same
   database, 2 batches of 8192 synthetic spectra, precursor +-20 ppm,
   fragment +-10 ppm) through
   ``Scorer(db, params).score_stream`` on the card, after one warm-up
   batch. The stage-1 kernel's launch counter is set to 0 just before and
   read just after; every batch must launch it. The warm-up batch's
   rescore inputs are kept for phase 25 (outside the timed run and its
   peak-memory window). Then one batch's time is broken down:
   host phases (synchronised) and, under torch.profiler, the device's
   busy time, the rescore and stage-1 kernels' device ms and top
   kernels.
4. Stage-1 kernel against plain: the kernel against its plain PyTorch
   version on the same CUDA tensors, at random segment shapes (among
   them shapes at the tiling's ragged edges: S * Lc off multiples of 32,
   Pk off multiples of 4, odd W, Z = 3, pct tolerances, empty windows)
   and at the main path's own segments; the int32 outputs must be equal.
   Timed with CUDA events at the main path's segments, kernel, plain
   version, kernel again, beside the card's bound for the same work and
   the kernel's share of it, and beside a second bound over real work
   only (finite peaks and ladder slots: the pads match nothing) and the
   share of the compares that are pads.
5. Narrow card against CPU: the first 512 spectra scored on the card and
   on the CPU (plain versions); every FeatureTable column must be equal.
6. Open path at full width: bench.py's open workload (the same database,
   precursor -500/+100 Da, fragment +-10 ppm, 4 batches of 512 spectra
   after one warm-up batch) through ``score_stream``. The sort kernels'
   and the peak-major kernels' counters are set to 0 just before and
   read just after; every batch must launch the row-sort kernel, and the
   range search (device-planned batches), the entry gather and the
   run-count top-K must launch. Prints the bands, nbcov, the size
   classes, F per segment, the device-planned batches and the overflow
   reruns (``fused_reruns``), the wall rate and peak memory, and one
   batch's profile with named ranges around the range search, the count
   core and, inside it, the gather, the sort and the count.
7. Cluster kernel on the open path: the default run of a device-planned
   batch (its sort inputs, and the first inputs of the peak-major
   kernels' wrappers, kept for phases 8 and 27), then one batch with the
   one-pass limit lowered to 1024 keys, so that every row goes to the
   cluster kernel
   (one launch a sort); it must launch, and every FeatureTable column
   must equal the default run's.
8. Sort kernels against plain: each kernel against its plain version and
   torch.sort at the open path's captured shapes, at phase 7's rows, at
   open rows of 2^16 keys shaped like phase 16's and at random shapes up
   to 2^17 keys a row, full-int32-range and all-equal rows among them;
   the outputs must be bit-equal. Timed with CUDA events beside
   torch.sort and the card's bound, kernel, torch.sort, kernel again,
   each shape with its share of the bound: the row-sort kernel at a
   device-planned batch's shapes and at the host-planned warm-up
   batch's, the cluster kernel at phase 7's rows and at the 2^16-key
   rows (at its own cluster size and at 4 and 8 CTAs a row, with
   cudaOccupancyMaxActiveClusters), beside the parent commit's whole
   long-row sort (PARENT_LONG_SORT_MS).
9. Open card against CPU: 128 open spectra on the card and on the CPU;
   every FeatureTable column must be equal; prints both scorers'
   ``fused_reruns``.
12. CLI on the card: ``python -m sage_tpu_torch config.json -o dir`` as a
    subprocess, on a 300-protein FASTA and a 512-spectrum MGF, must exit
    0, and its results.sage.tsv and results.sage.pin must be byte-equal
    to an in-process ``Runner(..., device="cpu")`` run on the same
    inputs.
13. Two-dispatch narrow at full width: phase 3's 2 x 8192 spectra through
    ``score_stream`` with SAGE_TPU_FUSED=0; the stage-1 counter must be
    > 0 and every FeatureTable column must equal phase 3's fused tables.
    Prints the wall rate and one batch's host phases.
14. Two-dispatch open: phase 6's 4 x 512 spectra with SAGE_TPU_FUSED=0;
    the row-sort counter and the peak-major kernels' counters (its range
    planning runs the range search and fetches the ranges) must be > 0
    and every column must equal phase 6's tables. An untimed rerun of its
    first batch keeps the peak-major kernels' inputs, each at the call
    with the most band pseudo-rows a query row (nbcov up to 10), for
    phase 27.
15. Banded narrow stage 1: phase 3's spectra with a +-1.5 Da precursor
    window (W = 4096 on this database) and +-10 ppm fragments, the banded
    stage 1 asked for with SAGE_TPU_NARROW_BANDED=1. After a warm-up
    batch, one 8192-spectrum batch through ``score_stream`` with the
    counters set to 0 just before: the banded branch and the row-sort
    kernel must run. Every column must equal the batch's with
    SAGE_TPU_NARROW_BANDED=0 (the candidate-major stage-1 kernel at
    Wb = 4096) and with no environment variable (the auto gate, which
    must take the path its predicate names), and 64 spectra must give
    equal columns on the card and the CPU. Prints W, nbcov, F, the
    largest entry count, the overflow reruns, the runs' spectra/s, peak
    memory and one batch's profile (range search, count core with its
    gather, sort and count, rescore); the range search, entry gather and
    count counters must be > 0; an untimed rerun keeps the sort inputs
    (checked against the plain version and timed here) and the peak-major
    kernels' first inputs (phase 27).
16. Banded, low-resolution fragments: phase 15 with +-0.5 Da fragments
    (+-1.0 Da if the entry rows stay within 2^15 keys), as ion-trap MS2
    is searched. The cluster kernel must launch on this path, once for
    each sort of rows past 2^15 keys (no other kernel for those rows);
    the columns must equal the candidate-major run's. The cluster kernel
    is checked against its plain version and torch.sort at every input
    the batch gave it, and timed there beside its bound and the parent
    commit's whole long-row sort of the same rows.
19. Banded against candidate-major (runs after 16): both stage 1s,
    forced, on phase 15's batch at +-3 and +-6 Da precursor windows
    (W = 8192, 16384; SAGE_TPU_OPEN_THRESHOLD raised so they stay
    narrow; phases 15 and 16 race the two at +-1.5 Da, W = 4096), each
    with +-10 ppm and +-0.5 Da fragments:
    every column equal, spectra/s of each path twice (banded,
    candidate-major, candidate-major, banded), and one profiled batch of
    each for the stage 1's device ms and the device's busy time. Prints
    whether both banded repetitions beat both candidate-major ones and
    which path the auto gate (set from these cells) takes.
17. Chimeric search: 2,048 spectra, each the peaks of two of the
    database's peptides within 1.5 Da (the precursor the first's),
    precursor +-1.5 Da, fragment +-10 ppm, report_psms 2, through
    ``score_stream``; the stage-1 kernel must launch; both peptides must
    be found in over half the spectra; 32 spectra on the card and the
    CPU must give equal columns. Prints the host's peak-removal seconds.
18. LFQ and the report: (a) ``python -m sage_tpu_torch`` on the card
    against ``Runner(..., device="cpu")`` on a 300-protein FASTA and two
    mzML files of 512 MS2 + 128 MS1 scans (isotope envelopes over an
    elution profile, the second file shifted in RT), with ``quant.lfq``,
    ``write_report`` and ``chimera``: results.sage.tsv, lfq.tsv and
    sage.report.html byte-equal (output directories replaced by a
    placeholder) and target MS1 peaks at 5% FDR; (b) the Runner on the
    card on a 6,000-protein FASTA and two files of 4,096 MS2 + 1,024 MS1
    scans: the run's, the quant's and the report's seconds.
22. Grid narrow (after phase 14): phase 3's first 8192-spectrum batch
    through ``ShardedScorer.score_table`` on grids of (2, 2) and (1, 4)
    shards, all on the card (shards on one card run one after another,
    so the rates say nothing of several cards). The windowed step must
    run, the stage-1 counter (0 just before each grid's batch) must be
    > 0, and every column must equal phase 3's table; the kernel must
    equal its plain version at two of the grid's launches.
23. Grid open: phase 6's first 2 x 512 spectra on grids of (1, 2),
    (2, 4) and (1, 32) (GRID_OPEN_SHAPES) with SAGE_TPU_SHARD_WINDOWED=0
    (at a model axis of 2 the open window fits one shard's peptide
    range, where the windowed step's gate would take it): every batch
    through the banded open step (B x F within MAX_ELEMENTS), each
    shard's entry rows sorted once by the row-sort kernel (F <= 2^15),
    the cluster kernel (F <= 2^17) or, past that, torch.sort, as on one
    device; F and the sort of each batch printed; the counters set to 0
    just before each grid's batches; every column equal to phase 6's;
    the row-sort and cluster counters > 0 over the phase, the peak-major
    kernels' counters > 0 on every grid (its range planning runs the
    range search on each model shard's device); each sort kernel equal
    to its plain version on a slice of the grid's rows.
10. The ``kernels`` JSON line, the nvidia-smi line, and the final
    ``{"ok": true, ...}`` line. ``launches`` is each kernel's count on
    its main path (phase 3, 6 or 16), ``launches_by_path`` its count on
    each path that runs it (stage-1: phases 3, 11, 20, 21 (both
    processes summed), 13, 17, phase 15's candidate-major run, 22
    (``sharded_narrow``) and 24 (``sharded_runner``); row sort: 6, 14,
    15, 16, 23 (``sharded_open``); cluster sort: 16, 6, 14, 23; phases 15
    and 16 count their banded runs; stage 1 and the rescore also
    count phase 26's two runs; the range search, entry gather and count:
    6, 14, 15, 16, 23). The cluster kernel's
    times are phase 16's; the peak-major kernels' main path is phase 6,
    their times phase 27's at phase 7's input, with phases 14's, 15's and
    16's rows beside them (``by_input``); phase 7's lowered-limit run adds
    ``forced_launches``; the rescore kernel's main path is phase 3, its
    paths 3, 6, 11, 13-17 (15 and 16 banded), 20, 22-24 and 26, its
    times phase 25's at phase 3's input. The batch-prep kernel's main
    path is phase 3 (one launch a batch), its paths 3, 6, 11, 13-17, 20,
    22-24 and 26 (must be 0 on 17 and 22-24, which keep the host's prep;
    phase 21's processes are not counted), its times phase 28's.
25. Rescore kernel against plain (runs after phase 17): the inputs of
    ``rescore_indexed`` (the ladder table, pep, spec, the peak rows, maxz
    and live) captured, outside every timed run, at phase 3's narrow and
    phase 6's open warm-up batch, phase 13's two-dispatch items (k = 1;
    an untimed run of its first batch) and phase 16's +-0.5 Da warm-up
    batch, and crafted edge shapes through the thin ``rescore_candidate``
    form (equal intensities, zero intensities, a zero denominator, -inf
    slots under ppm and da, rows of pads, n * k == 0, peaks on their IEEE
    bounds and one ulp either side, runs of equal masses, removed peaks,
    lo > hi, one item a row, several warps of items a row, the widest
    ladder, 4 x 64 slots at Z = 4): all seven outputs bit-equal to the
    plain version on the card. At each captured input, timed with CUDA
    events: kernel, plain version, kernel again, beside three bounds and
    the kernel's share of each: this design's (the live items' ladder
    rows and indices, the peak rows they read up to the first pad, and
    the outputs against 3.35 TB/s; the binary search's compares and the walk over
    each range for this run's data against 33.5 T/s), the linear scan's
    (every item, slot, live charge and peak) and the real-work bound
    (live items x finite slots x live charges x live peaks); and one
    call's host seconds without a synchronise beside the kernel's.
26. Large peak lists (runs after phase 25): 8 spectra of 12,000 peaks
    (``SpectrumProcessor(12000)``, as ``max_peaks`` 12,000 keeps them),
    precursor charge 4, fragment charges up to 3 (Z = 3), through the
    Scorer on the card, fused and two-dispatch (both kernels' counters 0
    just before each run and > 0 after), every column equal to the CPU
    port's run; the stage-1 kernel at the fused run's segments and the
    rescore kernel at both runs' inputs against their plain versions
    (bit-equal) and timed beside their bounds.
27. Peak-major kernels against plain (runs after phase 25): the range
    search (open grid or slot form, banded form), the entry gather and
    the run-count top-K against their plain versions on the card at
    crafted edges (tests/_peak_cases.py: fragments on the IEEE bounds,
    NaN and infinite peaks, empty bands and windows, rows past F, both
    key forms, K 50, 80 and 1024, a top-K buffer that compacts) and at
    the inputs kept on the main paths (phase 7's device-planned open
    batch, phase 14's two-dispatch open batch, phases 15's and 16's banded
    batches): outputs equal (i32). At
    each kept input timed with CUDA events around calls queued behind a
    spin kernel (a call's device work can be shorter than its host launch
    cost, which events around calls not held would time instead; that
    per-call time is printed too): kernel, plain version, kernel again,
    beside the card's bound for the same work and, for the range search,
    torch.searchsorted over the bands' composite keys (band * 2^17 +
    m/z), timed both ways.
28. Batch-prep kernel against plain and the host (runs after phase 5):
    the inputs of ``batch_prep`` captured at phase 3's warm-up batch
    (8192 spectra: their flat peaks and offsets, the query rows' window
    bounds, the device's peptide masses). The padded block and i0 / i1
    of the main path's own call, and of the kernel called again, must be
    bit-equal to the plain version on the same card tensors, to the
    host's prep of the same batch (``Scorer._pad_peaks`` and
    ``Scorer._expand_rows``) and to ``np.searchsorted`` over the bounds.
    Timed with CUDA events, kernel, plain version, kernel again, beside
    the card's bound for its bytes; prints the host's prep of the batch
    and ``Scorer._prep``'s, each synchronised.

A ``# record:`` line repeats the run's numbers as JSON.
"""

from __future__ import annotations

import base64
import contextlib
import json
import math
import os
import subprocess
import sys
import tempfile
import time
import zlib
from concurrent.futures import ThreadPoolExecutor

import numpy as np

# H100 SXM peaks. HBM bandwidth (NVIDIA data sheet). The f32 issue rate
# outside the tensor cores: the data sheet's 67 TFLOP/s counts a fused
# multiply-add as two operations; the stage-1 kernel does no multiply-
# adds, and each of its f32 compares is one instruction, so the compares
# are held against half of it: 132 SMs x 128 lanes x ~1.98 GHz. The
# 32-bit integer issue rate: 64 INT32 lanes per SM (NVIDIA H100 Tensor
# Core GPU Architecture white paper, the Hopper SM) x 132 SMs x 1.98 GHz
# boost clock (data sheet); the sorts' compares are held against it.
HBM_BYTES_PER_S = 3.35e12
F32_COMPARES_PER_S = 67e12 / 2
INT32_OPS_PER_S = 132 * 64 * 1.98e9
# bench.py's database: synth_fasta(20000), targets and decoys
PROTEINS = 20000
KERNELS = {
    "stage1_counts": ("sage_tpu_torch/csrc/stage1_counts.cu",
                      "sage_tpu/ops/pallas_stage1.py:49"),
    "row_sort": ("sage_tpu_torch/csrc/row_sort.cu",
                 "sage_tpu/ops/pallas_sort.py:52"),
    "cluster_sort": ("sage_tpu_torch/csrc/cluster_sort.cu",
                     "sage_tpu/ops/pallas_sort.py:73"),
    # no Pallas kernel: XLA fuses rescore_candidate into the stage-2
    # programs
    "rescore": ("sage_tpu_torch/csrc/rescore.cu",
                "sage_tpu/ops/search.py:285"),
    # no Pallas kernels: the XLA programs of the peak-major searches
    "peak_ranges": ("sage_tpu_torch/csrc/peak_ranges.cu",
                    "sage_tpu/ops/open_search.py:112"),
    "open_entries": ("sage_tpu_torch/csrc/open_entries.cu",
                     "sage_tpu/ops/open_search.py:423"),
    "open_count": ("sage_tpu_torch/csrc/open_count.cu",
                   "sage_tpu/ops/open_search.py:465"),
    # no TPU kernel: the host's peak padding and window search
    "batch_prep": ("sage_tpu_torch/csrc/batch_prep.cu",
                   "sage_tpu/ops/search.py _pad_peaks, _expand_rows"),
}
# the peak-major searches' kernels (ops/open_search.py's launch counters)
PEAK_KERNELS = ("peak_ranges", "open_entries", "open_count")
# The entry gather's and the count's kernel ms at phase 27's captured
# inputs before their redesign (the gather with a window search an
# entry, the count with a block a query row), measured by this script on
# an NVIDIA H100 80GB HBM3 at 700 W: printed in the log beside this
# run's, and in no JSON line
PREVIOUS_PEAK_MS = {
    "open_entries": {"open": 0.0414, "banded": 0.0955,
                     "banded_lowres": 0.316},
    "open_count": {"open": 0.106, "banded": 0.147, "banded_lowres": 0.268},
}
# The parent commit's whole long-row sort (its 2^15-key block sorts, the
# flip passes in torch and the bitonic merge kernel), ms a batch,
# measured by time_long_sort.py on an NVIDIA H100 80GB HBM3 at 700 W:
# phase 16's rows and phase 7's lowered-limit rows
PARENT_LONG_SORT_MS = {"phase16": 14.08, "phase7": 10.29}
# bench.py's open workload (bench.py:63-65, 683-699)
OPEN_BATCH = 512
OPEN_BATCHES = 4
# the one-pass limit of phase 7, below the open rows' length
LOWERED_BLOCK_MAX = 1024
# phases 15-17: a low-resolution precursor window, which puts a batch's
# widest window at W = 4096 candidates on bench.py's database
BANDED_PREC = ("da", -1.5, 1.5)
BANDED_BATCH = 8192
CHIMERA_SPECTRA = 2048
# phase 19: precursor windows (+-Da) that put the batch's widest window at
# W = 8192 and 16384 candidates, each with a ppm and a Da fragment
# tolerance (phases 15 and 16 race both stage 1s at W = 4096)
CROSSOVER_PREC = (3.0, 6.0)
CROSSOVER_FRAG = (("ppm", -10.0, 10.0), ("da", -0.5, 0.5))
# phase 23's grids, each on phase 6's first GRID_OPEN_BATCHES batches.
# A model shard's entry row holds all of its fragments that meet one of
# the spectrum's peaks (any precursor mass), so on bench.py's database F
# is 196,608 keys at a model axis of 2 (past MAX_F: torch.sort, as on
# one device), 114,688-131,072 at 4 (the cluster kernel) and
# 24,576-28,672 at 32 (the row-sort kernel)
GRID_OPEN_SHAPES = ((1, 2), (2, 4), (1, 32))
GRID_OPEN_BATCHES = 2
# phase 18's inputs: (proteins, MS2 scans, MS1 scans) of each of two files
LFQ_SMALL = (300, 512, 128)
LFQ_LARGE = (6000, 4096, 1024)
# phase 26: spectra of 12,000 peaks (max_peaks 12,000), past the 227 KB
# that kernels staging a whole peak row in shared memory could hold
LARGE_PEAKS = 12000
LARGE_PEAK_SPECTRA = 8


def log(*a):
    print(*a, flush=True)


class Phase:
    """Print a phase's seconds when it ends."""

    def __init__(self, name, times):
        self.name = name
        self.times = times

    def __enter__(self):
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        s = time.perf_counter() - self.t0
        self.times[self.name] = s
        if exc[0] is None:
            log(f"# phase {self.name}: {s:.1f} s")


def nvidia_smi_line() -> str:
    r = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return r.stdout.strip().splitlines()[0]


def exec_ms(fn, reps):
    """Mean device ms of ``fn`` over ``reps`` calls after a warm one, by
    the port's meter (``devprof.amortized_exec_s``: CUDA events)."""
    from sage_tpu_torch.utils.devprof import amortized_exec_s

    return 1e3 * amortized_exec_s(fn, reps)


def segment_work(ints, W, Lc, Z, S, Pk, B):
    """Bytes and compares that one stage-1 segment needs, from its rows:
    the ladder windows, peaks, rows and output each moved once; compares
    only for live candidates (inside [i0, i1)) and live charge planes
    (z < maxz), two per (fragment slot, peak, plane)."""
    spec, p0, i0, i1, maxz = (ints[j].astype(np.int64) for j in range(5))
    R = spec.size
    lo = np.maximum(i0, p0)
    hi = np.minimum(i1, p0 + W)
    live = np.maximum(hi - lo, 0)
    zact = np.clip(maxz - 1, 0, Z)
    ops = float((live * zact).sum()) * S * Lc * Pk * 2
    nbytes = (R * W * S * Lc * 4 + B * Pk * 4 + 5 * R * 4
              + R * (W + 2) * 4)
    return float(nbytes), ops


def segment_real_ops(torch, lad, peaks, ints, W, Lc, Z):
    """The compares of one stage-1 segment over real work only: two per
    (finite ladder slot of a live candidate, finite peak of its row's
    spectrum, live plane). The +inf peak pads (each spectrum padded to
    the batch's Pk) and the -inf slots past a peptide's length can match
    nothing; :func:`segment_work` counts them, as the kernel does."""
    P_pad, B = lad.shape[0], peaks.shape[0]
    slots = torch.isfinite(lad[:, :, :Lc]).sum((1, 2)).long()
    cum = torch.cat([slots.new_zeros(1), slots.cumsum(0)])
    npk = torch.isfinite(peaks).sum(1).long()
    spec, p0, i0, i1, maxz = (ints[j].long() for j in range(5))
    p0 = p0.clamp(0, P_pad - W)
    lo = torch.maximum(i0, p0).clamp(0, P_pad)
    hi = torch.maximum(torch.minimum(i1, p0 + W).clamp(0, P_pad), lo)
    zact = (maxz - 1).clamp(0, Z)
    return float(((cum[hi] - cum[lo]) * npk[spec.clamp(0, B - 1)]
                  * zact).sum()) * 2


def sort_work(rows, F):
    """Bytes and compares a sort of ``rows`` rows of F i32 keys needs:
    each key read and written once; n log2 n compares a row."""
    return 8.0 * rows * F, float(rows) * F * math.log2(max(F, 2))


def bound_ms(nbytes, ops, ops_per_s):
    t_b = nbytes / HBM_BYTES_PER_S
    t_o = ops / ops_per_s
    return max(t_b, t_o) * 1e3, ("bytes" if t_b >= t_o else "operations")


# The first kernel records of a torch.profiler window can be lost (seen
# on the card: the banded stage 1's first kernels, launched through
# ctypes after tens of ms of host work, had no records while later
# launches did). A window therefore opens with a few short spin kernels
# and a pause, which its readers leave out by name; that keeps most
# records, not every one.
PAD_KERNEL = "spin_kernel"


def profile_pad(torch, n=8):
    for _ in range(n):
        torch.cuda._sleep(1000)
    torch.cuda.synchronize()
    time.sleep(0.05)


def profile_batch(torch, scorer, batch, ranged, kernel_keys, top=8):
    """Where one batch's time goes: host phases of ``score_table`` timed
    with a synchronise after each, then the same batch under
    torch.profiler for the device's busy time, named ranges and the
    ``top`` host ops by device time, then once more with each named
    range's calls timed by CUDA events (``<name>_event_ms``).
    ``ranged``: (module, attribute)
    pairs wrapped in named ranges; ``kernel_keys``: label -> substring of
    a kernel's name."""
    sync = torch.cuda.synchronize
    ph = {}
    t0 = time.perf_counter()
    cols, peaks_dev, rows = scorer._prep(batch)
    sync()
    ph["prep_ms"] = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    fd = scorer._fused_dispatch(batch, cols, peaks_dev, rows=rows)
    ph["dispatch_host_ms"] = (time.perf_counter() - t0) * 1e3
    sync()
    ph["dispatch_to_done_ms"] = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    packed = fd["fused"].cpu().numpy()
    ph["fetch_ms"] = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    t = scorer._fused_finalize(fd, cols, packed=packed)
    assert t is not None, "profiled batch overflowed its sticky shapes"
    ph["finalize_ms"] = (time.perf_counter() - t0) * 1e3
    log("# batch phases (ms, synchronised): "
        + ", ".join(f"{k} {v:.2f}" for k, v in ph.items()))

    from torch.profiler import ProfilerActivity, profile, record_function

    names = [attr for _m, attr in ranged]
    originals = [(m, attr, getattr(m, attr)) for m, attr in ranged]

    def in_range(name, fn):
        def call(*a, **k):
            with record_function(name):
                return fn(*a, **k)
        return call

    for m, attr, fn in originals:
        setattr(m, attr, in_range(attr, fn))
    try:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            profile_pad(torch)
            t0 = time.perf_counter()
            scorer.score_table(batch)
            sync()
            wall = (time.perf_counter() - t0) * 1e3
    finally:
        for m, attr, fn in originals:
            setattr(m, attr, fn)
    ev = prof.key_averages()

    # The same batch once more, each named range's calls timed with CUDA
    # events on the current stream (start before the call, end after):
    # the device span of the work each call enqueued (and any wait for
    # the host inside the call), independent of the profiler's records.
    spans_ev = {n: 0.0 for n in names}
    pairs = []

    def in_events(name, fn):
        def call(*a, **k):
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            e0.record()
            out = fn(*a, **k)
            e1.record()
            pairs.append((name, e0, e1))
            return out
        return call

    for m, attr, fn in originals:
        setattr(m, attr, in_events(attr, fn))
    try:
        scorer.score_table(batch)
        sync()
    finally:
        for m, attr, fn in originals:
            setattr(m, attr, fn)
    for name, e0, e1 in pairs:
        spans_ev[name] += e0.elapsed_time(e1)

    def dev_us(e, own=True):
        keys = (("self_device_time_total", "self_cuda_time_total") if own
                else ("device_time_total", "cuda_time_total"))
        return next((getattr(e, n) for n in keys if hasattr(e, n)), 0.0)

    # Busy time sums the device's own events (kernels, copies) once each;
    # a host op's entry repeats the time of the kernels it launched, and a
    # named range shows up on the device too.
    on_dev = [e for e in ev if str(e.device_type).endswith("CUDA")
              and e.key not in names and PAD_KERNEL not in e.key]
    busy = sum(dev_us(e) for e in on_dev) / 1e3
    kern = {lab: sum(dev_us(e) for e in on_dev if sub in e.key) / 1e3
            for lab, sub in kernel_keys.items()}
    # A range's device time: the kernels its torch ops launched (a kernel
    # launched through ctypes is not attributed to a range; the kernel
    # sums above count those), and the span of its device-side event.
    stages = {n: sum(dev_us(e, own=False) for e in ev
                     if e.key == n and not str(e.device_type).endswith("CUDA"))
              / 1e3 for n in names}
    spans = {n: sum(dev_us(e) for e in ev
                    if e.key == n and str(e.device_type).endswith("CUDA"))
             / 1e3 for n in names}
    top = sorted((e for e in ev if not str(e.device_type).endswith("CUDA")),
                 key=dev_us, reverse=True)[:top]
    ph.update(profiled_wall_ms=wall, device_busy_ms=busy,
              **{f"{k}_kernel_device_ms": v for k, v in kern.items()},
              **{f"{n}_device_ms": v for n, v in stages.items()},
              **{f"{n}_device_span_ms": v for n, v in spans.items()},
              **{f"{n}_event_ms": v for n, v in spans_ev.items()},
              idle_share=(1 - busy / wall) if busy else None)
    if busy:
        log(f"# profile: score_table wall {wall:.2f} ms, device busy "
            f"{busy:.2f} ms, idle share {1 - busy / wall:.3f}; device ms: "
            + ", ".join(f"{k} kernel {v:.3f}" for k, v in kern.items())
            + "; ranges (their torch ops' kernels / device span): "
            + ", ".join(f"{n} {v:.2f} / {spans[n]:.2f}"
                        for n, v in stages.items())
            + "; CUDA-event spans of a second run: "
            + ", ".join(f"{n} {v:.3f}" for n, v in spans_ev.items()))
        if top:
            log("# host ops by the device time of the kernels they launched:")
        for e in top:
            log(f"#   {dev_us(e) / 1e3:8.3f} ms  x{e.count:<5d} {e.key[:70]}")
    else:
        log("# profile: no device time recorded (device busy: not measured)")
    return ph


def assert_tables_equal(a, b, what):
    assert len(a) == len(b) > 0, (what, len(a), len(b))
    for k in b.columns:
        np.testing.assert_array_equal(a.columns[k], b.columns[k],
                                      err_msg=f"{what}: column {k}")


def rescore_mod():
    """The rescore kernel's module: its wrapper, plain version and
    ``launches`` counter."""
    from sage_tpu_torch.ops import rescore

    return rescore


def prep_mod():
    """The batch-prep kernel's module: its wrapper, plain version and
    ``launches`` counter."""
    from sage_tpu_torch.ops import batch_prep

    return batch_prep


def keep_prep(store):
    """A ``Recording`` keep function for ``batch_prep`` that stores the
    first call's tensors (masses, intens, offs, lo, hi; clones, made on
    the stream of the call), the peptide masses (the scorer's own),
    its keywords and its outputs (clones)."""
    def keep(out, *a, **k):
        if not store:
            store.update(args=tuple(x.clone() for x in a[:5]) + (a[5],),
                         kw=dict(k), out=tuple(o.clone() for o in out))
    return keep


def keep_first(store, key):
    """A ``Recording`` keep function for ``rescore_indexed`` that stores,
    under ``key``, the first call's arguments as (args, keywords): args
    the seven tensors (lad, pep, spec, pkm, pki, maxz, live), live None
    where the caller passed none (every item live). The ladder table is
    the scorer's own (not copied: it is never written); the rest are
    clones."""
    def keep(out, *a, **k):
        if key not in store:
            k = dict(k)
            a = tuple(a) + ((k.pop("live", None),) if len(a) == 6 else ())
            store[key] = ((a[0],) + tuple(
                x.clone() if hasattr(x, "clone") else x for x in a[1:]), k)
    return keep


def capture_rescore(tsearch, store, key):
    """Until the block ends, keep the first rescore inputs of the
    Scorer's calls under ``store[key]`` (see :func:`keep_first`)."""
    return Recording(tsearch, "rescore_indexed", keep_first(store, key))


def reset_peak(topen):
    """Set the peak-major kernels' launch counters to 0."""
    for k in topen.launches:
        topen.launches[k] = 0


# profile_batch's kernels: label -> a substring of the kernel's name
PEAK_KERNEL_KEYS = {"row_sort": "row_sort_kernel",
                    "cluster_sort": "cluster_sort_kernel",
                    "rescore": "rescore_kernel",
                    "peak_ranges": "peak_ranges_",
                    "open_entries": "open_entries_kernel",
                    "open_count": "open_count_"}


def open_profile_ranges(topen, tsearch):
    """profile_batch's named ranges on the open path: the range search
    (either form), the count core's span and, inside it, the entry
    gather, the sort and the run-count top-K, then the rescore."""
    return [(topen, "_device_ranges"), (topen, "_device_ranges_flat"),
            (tsearch, "_device_open_count"), (topen, "open_entries"),
            (topen, "bitonic_sort_rows"), (topen, "open_count"),
            (tsearch, "rescore_indexed")]


def banded_profile_ranges(tbanded, topen, tsearch):
    """The same on the banded path: its range search, the count core's
    span and its three parts, the rescore."""
    return [(tbanded, "_banded_ranges"), (tbanded, "_open_count_core"),
            (topen, "open_entries"), (topen, "bitonic_sort_rows"),
            (topen, "open_count"), (tsearch, "rescore_indexed")]


class capture_peak:
    """Until the block ends, keep in ``store`` the first call's inputs of
    each of the peak-major kernels' wrappers, as (args, keywords): the
    first argument (a table, or the sorted rows) by reference, every
    other tensor cloned. ``widest``: keep instead the first call with the
    most band pseudo-rows a query row (keyword ``nbcov``)."""

    def __init__(self, topen, tbanded, store, widest=False):
        targets = [(topen, "_device_ranges", "ranges"),
                   (topen, "_device_ranges_flat", "ranges_flat"),
                   (topen, "open_entries", "entries"),
                   (topen, "open_count", "count")]
        if tbanded is not None:
            targets.append((tbanded, "_banded_ranges", "banded_ranges"))
        self.recs = [Recording(o, a, self.keep(store, key, widest))
                     for o, a, key in targets]

    @staticmethod
    def keep(store, key, widest):
        def keep(out, *a, **k):
            if key not in store or (
                    widest and k.get("nbcov", 1)
                    > store[key][1].get("nbcov", 1)):
                store[key] = ((a[0],) + tuple(
                    x.clone() if hasattr(x, "clone") else x for x in a[1:]),
                    dict(k))
        return keep

    def __enter__(self):
        for r in self.recs:
            r.__enter__()
        return self

    def __exit__(self, *exc):
        for r in reversed(self.recs):
            r.__exit__(*exc)


def build_kernels(_cuda_build):
    """Build the kernel sources side by side (one nvcc each), then load
    them; the wrappers find the loaded libraries by name."""
    names = tuple(KERNELS)
    flags = ["-Xptxas", "-v"]
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(names)) as ex:
        list(ex.map(lambda n: _cuda_build.build(n, flags), names))
    for n in names:
        _cuda_build.load(n, flags)
    build_s = time.perf_counter() - t0
    for n in names:
        secs, ptxas = _cuda_build.build_logs.get(n, (0.0, ""))
        for line in ptxas.splitlines():
            if "registers" in line or "smem" in line or "spill" in line:
                log(f"# ptxas {n}: {line.strip()}")
        log(f"# build: {n} in {secs:.2f} s")
    log(f"# build: {len(names)} sources in {build_s:.2f} s wall")
    return build_s


def narrow_phases(torch, tsearch, pallas_stage1, db, spectra, dev, times,
                  rescore_in):
    """Phases 3-5 and 28 (the narrow search). Returns the record, the
    stage-1 and batch-prep kernels' entries and phase 3's (params,
    batches, tables); the warm-up batch's rescore inputs go into
    ``rescore_in["narrow"]``."""
    batch = 8192
    warm, b1, b2 = (spectra[i * batch:(i + 1) * batch] for i in range(3))
    params = tsearch.SearchParams(
        precursor_tol=tsearch.Tolerance("ppm", -20.0, 20.0),
        fragment_tol=tsearch.Tolerance("ppm", -10.0, 10.0),
    )
    out = {}
    with Phase("3_narrow_main_path", times):
        t0 = time.perf_counter()
        scorer = tsearch.Scorer(db, params)
        torch.cuda.synchronize()
        log(f"# tables: P_pad {scorer.tables.P_pad}, L {scorer.tables.L}, "
            f"S {scorer.n_series}, on {scorer.device} in "
            f"{time.perf_counter() - t0:.2f} s")

        # warm-up batch; its stage-1 segments are recorded for phase 4
        captured = []
        real_s1 = tsearch.stage1_counts

        def recording(lad, peaks, ints, **kw):
            captured.append((peaks, ints, kw))
            return real_s1(lad, peaks, ints, **kw)

        tsearch.stage1_counts = recording
        prep_in = {}
        try:
            with capture_rescore(tsearch, rescore_in, "narrow"), \
                    Recording(tsearch, "batch_prep", keep_prep(prep_in)):
                t0 = time.perf_counter()
                warm_tables = list(scorer.score_stream([warm]))
                warm_s = time.perf_counter() - t0
        finally:
            tsearch.stage1_counts = real_s1
        log(f"# warm-up batch: {batch} spectra in {warm_s:.2f} s, "
            f"{len(warm_tables[0])} PSMs")

        per_batch = []
        real_dispatch = scorer._fused_dispatch

        def counting_dispatch(*a, **k):
            n0 = pallas_stage1.launches
            d = real_dispatch(*a, **k)
            per_batch.append(pallas_stage1.launches - n0)
            return d

        scorer._fused_dispatch = counting_dispatch
        trescore = rescore_mod()
        tprep = prep_mod()
        torch.cuda.reset_peak_memory_stats()
        pallas_stage1.launches = 0
        trescore.launches = 0
        tprep.launches = 0
        t0 = time.perf_counter()
        tables = list(scorer.score_stream([b1, b2]))
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0
        launches = pallas_stage1.launches
        r_launches = trescore.launches
        p_launches = tprep.launches
        peak_gib = torch.cuda.max_memory_allocated() / 2**30
        scorer._fused_dispatch = real_dispatch
        lp = scorer.last_plan
        log(f"# plan (Wb, Lcb, Rb, Zc): {list(lp['plan'])}")
        log(f"# plan rows per segment: {lp['seg_rows']}, G_eff "
            f"{lp['G_eff']}, W {lp['W']}, Ksel {lp['Ksel']}")
        log(f"# main path: 2 x {batch} spectra in {wall_s:.3f} s wall = "
            f"{2 * batch / wall_s:.1f} spectra/s; stage1_counts launches "
            f"{launches} (per batch {per_batch}), rescore {r_launches}, "
            f"batch_prep {p_launches}; peak device memory {peak_gib:.2f} GiB")
        assert len(per_batch) == 2 and all(n > 0 for n in per_batch), \
            per_batch
        assert p_launches == 2, f"narrow: batch_prep launches {p_launches}"
        assert launches == sum(per_batch) > 0
        assert r_launches > 0, "narrow: the rescore kernel did not launch"
        n_psm = 0
        for t, bt in zip(tables, (b1, b2)):
            assert len(t) > 0.9 * len(bt), (len(t), len(bt))
            assert np.isfinite(t.columns["hyperscore"]).all()
            assert (t.columns["matched_peaks"]
                    >= params.min_matched_peaks).all()
            # synthetic spectra carry their peptide's precursor mass
            assert (np.abs(t.columns["delta_mass"]) <= 20.5).all()
            n_psm += len(t)
        log(f"# main path PSMs: {n_psm}")
        breakdown = profile_batch(
            torch, scorer, b1,
            [(tsearch, "rescore_indexed"), (tsearch, "_topk_layout")],
            {"stage1": "stage1_counts", "rescore": "rescore_kernel"},
        )
    out.update(batch=batch, wall_s_2_batches=wall_s,
               spectra_per_s=2 * batch / wall_s,
               launches_per_batch=per_batch, rescore_launches=r_launches,
               prep_launches=p_launches, peak_device_gib=peak_gib,
               plan=[list(e) for e in lp["plan"]], seg_rows=lp["seg_rows"],
               batch_breakdown=breakdown)

    with Phase("4_stage1_kernel_vs_plain", times):
        lad = scorer.tables.lad_index
        S, L = scorer.n_series, scorer.tables.L
        P_pad = scorer.tables.P_pad
        rng = np.random.default_rng(0)
        masses, _intens, Pk = scorer._pad_peaks(warm[:256])
        peaks_r = torch.from_numpy(masses).to(dev)
        max_err = 0
        n_shapes = 0
        for W in (8, 16, 40, 48, 64, 256):
            for Z in (1, 2, 3):
                for tol in (("ppm", -10.0, 10.0), ("da", -0.02, 0.02)):
                    R = 512
                    p0 = rng.integers(0, len(db) - W, R)
                    i0 = p0 + rng.integers(0, W // 4 + 1, R)
                    ints = np.stack([
                        rng.integers(0, 256, R), np.minimum(p0, P_pad - W),
                        i0, i0 + rng.integers(0, W + 1, R),
                        rng.choice([2, 3, 4], R),
                    ]).astype(np.int32)
                    ints_d = torch.from_numpy(ints).to(dev)
                    Lc = int(rng.choice([12, 24, L]))
                    kw = dict(W=W, Lc=min(Lc, L), Z=Z, tol=tol)
                    got = pallas_stage1.stage1_counts(lad, peaks_r, ints_d,
                                                      **kw)
                    want = pallas_stage1.stage1_counts_plain(
                        lad, peaks_r, ints_d, **kw)
                    torch.cuda.synchronize()
                    err = int((got.long() - want.long()).abs().max())
                    assert int((want[:, :W] > 0).sum()) > 0
                    assert err == 0, (W, Z, tol, Lc, err)
                    max_err = max(max_err, err)
                    n_shapes += 1
        # the tiling's ragged edges: S * Lc off multiples of 32, Pk off
        # multiples of 4 (the peaks sliced), odd W, Z = 3, pct tolerances,
        # empty windows (i1 <= i0) and rows with no live plane (maxz 1)
        for W, Lc, pk, tol in ((33, 7, 37, ("pct", -0.002, 0.002)),
                               (257, 11, Pk - 1, ("ppm", -10.0, 10.0)),
                               (100, 13, 5, ("da", -0.02, 0.02)),
                               (1, 1, 1, ("ppm", -10.0, 10.0)),
                               (300, L, Pk - 3, ("pct", -0.001, 0.001))):
            R = 333
            p0 = rng.integers(0, len(db) - W, R)
            i0 = p0 + rng.integers(-2, W // 4 + 2, R)
            ints = np.stack([
                rng.integers(0, 256, R), np.minimum(p0, P_pad - W), i0,
                i0 + rng.integers(-1, W + 2, R), rng.choice([1, 2, 3, 4], R),
            ]).astype(np.int32)
            ints_d = torch.from_numpy(ints).to(dev)
            peaks_k = peaks_r[:, :pk].contiguous()
            kw = dict(W=W, Lc=min(Lc, L), Z=3, tol=tol)
            got = pallas_stage1.stage1_counts(lad, peaks_k, ints_d, **kw)
            want = pallas_stage1.stage1_counts_plain(lad, peaks_k, ints_d,
                                                     **kw)
            torch.cuda.synchronize()
            err = int((got.long() - want.long()).abs().max())
            assert err == 0, (W, Lc, pk, tol, err)
            n_shapes += 1
        log(f"# kernel vs plain: {n_shapes} random segment shapes equal "
            f"(max |err| {max_err})")

        # per captured segment: kernel, plain version, kernel again
        reps = 20
        k_ms = p_ms = 0.0
        nbytes_t = ops_t = real_t = 0.0
        for peaks, ints_d, kw in captured:
            got = pallas_stage1.stage1_counts(lad, peaks, ints_d, **kw)
            want = pallas_stage1.stage1_counts_plain(lad, peaks, ints_d, **kw)
            torch.cuda.synchronize()
            err = int((got.long() - want.long()).abs().max())
            assert err == 0, (kw, err)

            def kern():
                return pallas_stage1.stage1_counts(lad, peaks, ints_d, **kw)

            km1 = exec_ms(kern, reps)
            pm = exec_ms(lambda: pallas_stage1.stage1_counts_plain(
                lad, peaks, ints_d, **kw), 3)
            km2 = exec_ms(kern, reps)
            km = (km1 + km2) / 2
            nb, ops = segment_work(ints_d.cpu().numpy(), kw["W"], kw["Lc"],
                                   kw["Z"], S, peaks.shape[1], peaks.shape[0])
            real = segment_real_ops(torch, lad, peaks, ints_d, kw["W"],
                                    kw["Lc"], kw["Z"])
            bm, by = bound_ms(nb, ops, F32_COMPARES_PER_S)
            rm, _ = bound_ms(nb, real, F32_COMPARES_PER_S)
            log(f"# segment W={kw['W']} Lc={kw['Lc']} R={ints_d.shape[1]} "
                f"Pk={peaks.shape[1]} Z={kw['Z']}: kernel {km1:.4f} / "
                f"{km2:.4f} ms, plain {pm:.3f} ms, bound {bm:.4f} ms ({by}; "
                f"{nb / 1e6:.2f} MB, {ops / 1e9:.3f} G compares), share of "
                f"bound {bm / km:.3f}; real-work bound {rm:.4f} ms "
                f"({real / 1e9:.3f} G compares, pads {1 - real / ops:.3f} of "
                f"the compares), share {rm / km:.3f}")
            k_ms += km
            p_ms += pm
            nbytes_t += nb
            ops_t += ops
            real_t += real
        b_ms, b_by = bound_ms(nbytes_t, ops_t, F32_COMPARES_PER_S)
        r_ms, r_by = bound_ms(nbytes_t, real_t, F32_COMPARES_PER_S)
        log(f"# stage1_counts per {batch}-spectrum batch ({len(captured)} "
            f"launches): kernel {k_ms:.4f} ms, plain {p_ms:.3f} ms, bound "
            f"{b_ms:.4f} ms ({b_by}; {nbytes_t / 1e6:.1f} MB at "
            f"{HBM_BYTES_PER_S / 1e12:.2f} TB/s, {ops_t / 1e9:.2f} G f32 "
            f"compares at {F32_COMPARES_PER_S / 1e12:.1f} T/s issue rate); "
            f"share of bound {b_ms / k_ms:.3f}")
        log(f"# stage1_counts real-work bound (finite peaks and ladder slots "
            f"only): {r_ms:.4f} ms ({r_by}; {real_t / 1e9:.2f} G compares, "
            f"pads {1 - real_t / ops_t:.3f} of the compares above); share of "
            f"it {r_ms / k_ms:.3f}")
    kernel = {"name": "stage1_counts", "launches": launches,
              "max_abs_err": max_err, "ms": k_ms, "plain_ms": p_ms,
              "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
              "bound_share": b_ms / k_ms, "real_bound_ms": r_ms,
              "real_bound_by": r_by, "real_bound_share": r_ms / k_ms,
              "pad_share_of_compares": 1 - real_t / ops_t}

    with Phase("5_narrow_card_vs_cpu", times):
        sub = b1[:512]
        t_gpu = tsearch.Scorer(db, params).score_table(sub)
        t_cpu = tsearch.Scorer(db, params, device="cpu").score_table(sub)
        assert_tables_equal(t_gpu, t_cpu, "narrow card vs CPU")
        log(f"# narrow card vs CPU: {len(t_cpu)} PSMs of {len(sub)} spectra, "
            f"all {len(t_cpu.columns)} FeatureTable columns equal")
    k_prep = prep_phase(torch, tprep, scorer, warm, prep_in, times)
    k_prep["launches"] = p_launches
    return out, kernel, k_prep, (params, [b1, b2], tables)


def prep_phase(torch, tprep, scorer, batch, captured, times):
    """Phase 28: the batch-prep kernel at the inputs of phase 3's warm-up
    batch ``batch`` (``captured``: see :func:`keep_prep`). Returns the
    kernel's entry of the ``kernels`` line (less its launches)."""
    sync = torch.cuda.synchronize
    with Phase("28_batch_prep_kernel_vs_plain", times):
        sync()
        args, kw, out = captured["args"], captured["kw"], captured["out"]
        masses, intens, offs, lo, hi, mono = args
        P, Pk = kw["P"], kw["Pk"]
        S, N, R = offs.numel() - 1, masses.numel(), lo.numel()
        assert S == len(batch), (S, len(batch))
        got = tprep.batch_prep(*args, **kw)
        want = tprep.batch_prep_plain(*args, **kw)
        sync()

        def bits(x):
            return x.view(torch.int32) if x.dtype == torch.float32 else x

        for pair, what in (((out, want), "the main path's call"),
                           ((got, want), "the kernel called again")):
            for i, part in enumerate(("block", "i0 / i1")):
                assert torch.equal(bits(pair[0][i]), bits(pair[1][i])), (
                    f"batch_prep: {what}'s {part} differs from the plain "
                    f"version's")
        t0 = time.perf_counter()
        h_m, h_i, h_Pk = scorer._pad_peaks(batch)
        rows = scorer._expand_rows(batch)
        host_ms = (time.perf_counter() - t0) * 1e3
        assert h_Pk == Pk, (h_Pk, Pk)
        block = out[0].cpu().numpy()
        i01 = out[1].cpu().numpy()
        np.testing.assert_array_equal(block.view(np.uint32),
                                      np.stack([h_m, h_i]).view(np.uint32))
        np.testing.assert_array_equal(i01[0], rows["i0"])
        np.testing.assert_array_equal(i01[1], rows["i1"])
        mono_h = scorer.db.table.mono
        lo_h, hi_h = lo.cpu().numpy(), hi.cpu().numpy()
        np.testing.assert_array_equal(
            i01[0], np.searchsorted(mono_h, lo_h, side="left"))
        np.testing.assert_array_equal(
            i01[1], np.searchsorted(mono_h, hi_h, side="right"))
        t0 = time.perf_counter()
        scorer._prep(batch)
        sync()
        prep_ms = (time.perf_counter() - t0) * 1e3

        def kern():
            return tprep.batch_prep(*args, **kw)

        km1 = exec_ms(kern, 50)
        pm = exec_ms(lambda: tprep.batch_prep_plain(*args, **kw), 5)
        km2 = exec_ms(kern, 50)
        km = (km1 + km2) / 2
        # bytes: the flat peaks, offsets and bounds read, the block and
        # i0 / i1 written (the searches' loads of the peptide masses hit
        # L2 mostly and are left out, so the bound stays a lower bound);
        # compares: one a search step
        read = 8 * N + 4 * (S + 1) + 8 * R
        written = 8 * S * Pk + 8 * R
        ops = 2 * R * max(int(P).bit_length(), 1)
        bm, by = bound_ms(read + written, ops, F32_COMPARES_PER_S)
        log(f"# batch_prep at phase 3's warm-up batch (S {S}, N {N} peaks, "
            f"R {R} rows, P {P} masses, Pk {Pk}): the main path's block and "
            f"i0 / i1, and the kernel's again, bit-equal to the plain "
            f"version, to the host's _pad_peaks / _expand_rows and to "
            f"np.searchsorted; kernel {km1:.4f} / {km2:.4f} ms, plain "
            f"{pm:.3f} ms, bound {bm:.4f} ms ({by}; {read / 1e6:.2f} MB "
            f"read, {written / 1e6:.2f} MB written at "
            f"{HBM_BYTES_PER_S / 1e12:.2f} TB/s), share of bound "
            f"{bm / km:.3f}; the host's prep of the batch {host_ms:.1f} ms, "
            f"Scorer._prep {prep_ms:.1f} ms (synchronised)")
    return {"name": "batch_prep", "max_abs_err": 0, "ms": km,
            "plain_ms": pm, "bound_ms": bm, "bound_by": by,
            "bound_share": bm / km, "library_ms": None,
            "host_prep_ms": host_ms, "prep_ms": prep_ms, "S": S, "N": N,
            "R": R, "P": P, "Pk": Pk, "read_bytes": read,
            "written_bytes": written}


def open_phases(torch, tsearch, topen, pallas_sort, db, spectra, dev, times,
                rescore_in, peak_in):
    """Phases 6-9 (the open search). Returns the record, the sort
    kernels' entries and phase 6's (params, batches, tables); the warm-up
    batch's rescore inputs go into ``rescore_in["open"]``, the first
    inputs of the peak-major kernels' wrappers in phase 7's untimed run
    of a device-planned batch into ``peak_in["open"]``."""
    params = tsearch.SearchParams(
        precursor_tol=tsearch.Tolerance("da", -500.0, 100.0),
        fragment_tol=tsearch.Tolerance("ppm", -10.0, 10.0),
    )
    B = OPEN_BATCH
    warm = spectra[:B]
    batches = [spectra[(i + 1) * B:(i + 2) * B] for i in range(OPEN_BATCHES)]
    out = {}
    with Phase("6_open_main_path", times):
        t0 = time.perf_counter()
        scorer = tsearch.Scorer(db, params)
        os_ = scorer._open_searcher()
        torch.cuda.synchronize()
        log(f"# open searcher: {os_.n_bands} bands of {os_.band_w} "
            f"peptides, {db.num_fragments} fragments on {os_.device}, in "
            f"{time.perf_counter() - t0:.2f} s")

        # warm-up batch (host-planned: records the sticky shapes); its sort
        # inputs are recorded for phase 8
        warm_sorts = []
        real_sort = topen.bitonic_sort_rows

        def recording(key, *a, **k):
            warm_sorts.append(key.clone())
            return real_sort(key, *a, **k)

        topen.bitonic_sort_rows = recording
        try:
            with capture_rescore(tsearch, rescore_in, "open"):
                t0 = time.perf_counter()
                warm_t = list(scorer.score_stream([warm]))
                warm_s = time.perf_counter() - t0
        finally:
            topen.bitonic_sort_rows = real_sort
        wp = scorer.last_plan
        assert wp.get("open"), "the open workload did not take the open path"
        log(f"# open warm-up batch: {B} spectra in {warm_s:.2f} s, "
            f"{len(warm_t[0])} PSMs; plan {wp}")

        per_batch = []
        real_dispatch = scorer._fused_dispatch

        def counting_dispatch(*a, **k):
            n0 = pallas_sort.launches["row_sort"]
            d = real_dispatch(*a, **k)
            per_batch.append((pallas_sort.launches["row_sort"] - n0,
                              dict(scorer.last_plan)))
            return d

        scorer._fused_dispatch = counting_dispatch
        reruns0 = scorer.fused_reruns
        trescore = rescore_mod()
        tprep = prep_mod()
        torch.cuda.reset_peak_memory_stats()
        for k in pallas_sort.launches:
            pallas_sort.launches[k] = 0
        trescore.launches = 0
        tprep.launches = 0
        reset_peak(topen)
        t0 = time.perf_counter()
        tables = list(scorer.score_stream(batches))
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0
        launches = dict(pallas_sort.launches)
        r_launches = trescore.launches
        p_launches = tprep.launches
        peak_launches = dict(topen.launches)
        peak_gib = torch.cuda.max_memory_allocated() / 2**30
        scorer._fused_dispatch = real_dispatch
        reruns = scorer.fused_reruns - reruns0
        n_dev = sum(1 for _n, p in per_batch if p["device_planned"])
        for i, (n, p) in enumerate(per_batch):
            log(f"# open dispatch {i}: sort launches {n}, device-planned "
                f"{p['device_planned']}, bands {p['n_bands']}, nbcov "
                f"{p['nbcov']}, segments {list(p['plan'])}, F per segment "
                f"{p['F']}, Wc {p['Wc']}, chunked {p['chunked']}, classes "
                f"{p['classes']}")
        log(f"# open main path: {OPEN_BATCHES} x {B} spectra in "
            f"{wall_s:.3f} s wall = {OPEN_BATCHES * B / wall_s:.1f} "
            f"spectra/s; sort launches {launches['row_sort']}, cluster "
            f"launches {launches['cluster_sort']}, rescore {r_launches}, "
            f"batch_prep {p_launches}, {peak_launches}; {n_dev} of "
            f"{len(per_batch)} dispatches device-planned; fused_reruns "
            f"{reruns} (overflowed batches scored again through the "
            f"two-dispatch path); peak device memory {peak_gib:.2f} GiB")
        assert len(per_batch) == OPEN_BATCHES
        assert all(n > 0 for n, _p in per_batch), per_batch
        assert launches["row_sort"] == sum(n for n, _p in per_batch)
        assert r_launches > 0, "open: the rescore kernel did not launch"
        assert p_launches == len(batches), (p_launches, len(batches))
        assert n_dev > 0 and all(peak_launches[k] > 0 for k in PEAK_KERNELS), (
            peak_launches)
        for t, bt in zip(tables, batches):
            assert len(t) > 0.9 * len(bt), (len(t), len(bt))
            assert np.isfinite(t.columns["hyperscore"]).all()
            assert (t.columns["matched_peaks"]
                    >= params.min_matched_peaks).all()
            # -500/+100 Da window, in ppm of the precursor mass
            assert np.isfinite(t.columns["delta_mass"]).all()
        log(f"# open main path PSMs: {sum(len(t) for t in tables)}")
        breakdown = profile_batch(
            torch, scorer, batches[0], open_profile_ranges(topen, tsearch),
            PEAK_KERNEL_KEYS)
    out.update(batch=B, batches=OPEN_BATCHES, wall_s=wall_s,
               spectra_per_s=OPEN_BATCHES * B / wall_s,
               rescore_launches=r_launches, peak_launches=peak_launches,
               prep_launches=p_launches,
               sort_launches_per_dispatch=[n for n, _p in per_batch],
               device_planned=n_dev, reruns=reruns, peak_device_gib=peak_gib,
               plans=[p for _n, p in per_batch],
               batch_breakdown=breakdown)

    with Phase("7_open_cluster_kernel", times):
        # the default run of a device-planned batch; its sort inputs are
        # recorded for phase 8
        b = batches[0]
        captured = []
        peak_in["open"] = {"searcher": os_}
        with Recording(topen, "bitonic_sort_rows",
                       lambda out, key, *a, **k: captured.append(key.clone())
                       ), capture_peak(topen, None, peak_in["open"]):
            scorer._psm_counter = 1
            t_default = scorer.score_table(b)
        assert scorer.last_plan["device_planned"]
        clustered = []
        block_max = pallas_sort._BLOCK_MAX
        pallas_sort._BLOCK_MAX = LOWERED_BLOCK_MAX
        for k in pallas_sort.launches:
            pallas_sort.launches[k] = 0
        try:
            with Recording(pallas_sort, "cluster_sort",
                           lambda out, x, *a, **k: clustered.append(x.clone())):
                scorer._psm_counter = 1
                t_low = scorer.score_table(b)
                torch.cuda.synchronize()
        finally:
            pallas_sort._BLOCK_MAX = block_max
        low_launches = dict(pallas_sort.launches)
        log(f"# lowered one-pass limit {LOWERED_BLOCK_MAX}: sort launches "
            f"{low_launches['row_sort']}, cluster launches "
            f"{low_launches['cluster_sort']}, F per segment "
            f"{scorer.last_plan['F']}, rows {[list(x.shape) for x in clustered]}")
        assert low_launches["cluster_sort"] == len(clustered) > 0, low_launches
        assert_tables_equal(t_low, t_default, "lowered one-pass limit")
        log(f"# lowered one-pass limit: all {len(t_default.columns)} "
            f"FeatureTable columns equal the default run's "
            f"({len(t_default)} PSMs)")

    with Phase("8_sort_kernels_vs_plain", times):
        rng = np.random.default_rng(1)
        n_checked = 0
        shapes = [(k.shape[0], k.shape[1]) for k in captured]
        rand = [(16, 1), (64, 100), (256, 1000), (512, 4096), (64, 20000),
                (64, 32768), (32, 32769), (32, 50000), (16, 100000),
                (8, 131072)]
        for B_r, F_r in rand:
            x = torch.from_numpy(rng.integers(
                -(2**26), 2**26, size=(B_r, F_r)).astype(np.int32)).to(dev)
            x[:, F_r // 3:F_r // 3 + 5] = 2**31 - 1
            got = pallas_sort.bitonic_sort_rows(x)
            assert torch.equal(got, torch.sort(x, dim=1).values), (B_r, F_r)
            assert torch.equal(got, _plain_sort(pallas_sort, x)), (B_r, F_r)
            n_checked += 1
        # every digit pass's edge: the full int32 range (its landmarks in
        # every row) and all-equal rows (every pass skipped)
        for kind in ("int32_range", "equal"):
            for B_r, F_r in ((64, 20480), (32, 32768), (8, 40000),
                             (8, 131072)):
                x = _edge_keys(torch, rng, kind, B_r, F_r, dev)
                got = pallas_sort.bitonic_sort_rows(x)
                assert torch.equal(got, torch.sort(x, dim=1).values), (
                    kind, F_r)
                assert torch.equal(got, _plain_sort(pallas_sort, x))
                n_checked += 1
        for x in warm_sorts + captured:
            got = pallas_sort.bitonic_sort_rows(x)
            assert torch.equal(got, pallas_sort.sort_rows_plain(x))
            assert torch.equal(got, torch.sort(x, dim=1).values)
            n_checked += 1
        # the cluster kernel at phase 7's rows and at open rows of 2^16
        # keys shaped like phase 16's (one batch of them)
        open16 = [_open_rows(torch, rng, 2048, 1 << 16, dev)
                  for _ in range(2)]
        for x in clustered + open16:
            got = pallas_sort.cluster_sort(x)
            assert torch.equal(got, pallas_sort.cluster_sort_plain(x))
            assert torch.equal(got, torch.sort(x, dim=1).values)
            n_checked += 1
        torch.cuda.synchronize()
        log(f"# sort kernels vs plain: {n_checked} inputs bit-equal (kernel, "
            f"plain version and torch.sort); captured open rows: warm-up "
            f"{[tuple(x.shape) for x in warm_sorts]}, device-planned {shapes}")

        # the sort kernel per batch at the device-planned batch's shapes
        # (the main path's) and at the host-planned warm-up batch's
        sort_t = time_sorts(torch, pallas_sort, captured, f"device-planned "
                            f"{B}-spectrum open batch")
        warm_sort_t = time_sorts(torch, pallas_sort, warm_sorts,
                                 f"host-planned {B}-spectrum warm-up batch")
        forced_t = time_cluster(
            torch, pallas_sort, clustered,
            f"phase 7's lowered-limit batch ({len(clustered)} launches)",
            parent="phase7")
        open16_t = time_cluster(torch, pallas_sort, open16,
                                "2 x [2048, 65536] open rows")
        for n in (4, 8):
            blk = -(-open16[0].shape[1] // n)
            open16_t[f"ctas{n}_ms"] = time_cluster(
                torch, pallas_sort, open16, f"2 x [2048, 65536] open rows, "
                f"{n} CTAs a row", block=blk)["ms"]
    out.update(sort_warmup=warm_sort_t, cluster_forced=forced_t,
               cluster_open16=open16_t)
    kernels = [
        {"name": "row_sort", "launches": launches["row_sort"],
         "max_abs_err": 0, **sort_t, "warmup_ms": warm_sort_t["ms"],
         "warmup_library_ms": warm_sort_t["library_ms"],
         "warmup_bound_ms": warm_sort_t["bound_ms"]},
        # the main path launches the cluster kernel only for rows past 2^15
        # keys, which this workload never gives it; phase 7's lowered-limit
        # run launches it (forced_launches)
        {"name": "cluster_sort", "launches": launches["cluster_sort"],
         "forced_launches": low_launches["cluster_sort"],
         "forced_ms": forced_t["ms"], "open16_ms": open16_t["ms"],
         "open16_bound_ms": open16_t["bound_ms"]},
    ]

    with Phase("9_open_card_vs_cpu", times):
        sub = batches[1][:128]
        s_gpu = tsearch.Scorer(db, params)
        s_cpu = tsearch.Scorer(db, params, device="cpu")
        t_gpu = s_gpu.score_table(sub)
        t_cpu = s_cpu.score_table(sub)
        assert_tables_equal(t_gpu, t_cpu, "open card vs CPU")
        assert s_gpu.fused_reruns == s_cpu.fused_reruns
        log(f"# open card vs CPU: {len(t_cpu)} PSMs of {len(sub)} spectra, "
            f"all {len(t_cpu.columns)} FeatureTable columns equal; "
            f"fused_reruns {s_gpu.fused_reruns} on the card, "
            f"{s_cpu.fused_reruns} on the CPU")
    return out, kernels, (params, batches, tables)


def time_sorts(torch, pallas_sort, xs, what, reps=20):
    """The row-sort kernel (through ``bitonic_sort_rows``), torch.sort
    and the kernel again, then its plain version, on each input of
    ``xs``, timed with CUDA events and summed, beside the card's bound
    for the same work and the kernel's share of it."""
    t = dict(ms=0.0, plain_ms=0.0, library_ms=0.0)
    nb_t = ops_t = 0.0
    for x in xs:
        R_x, F_x = x.shape
        km1 = exec_ms(lambda: pallas_sort.bitonic_sort_rows(x), reps)
        lm = exec_ms(lambda: torch.sort(x, dim=1), reps)
        km2 = exec_ms(lambda: pallas_sort.bitonic_sort_rows(x), reps)
        km = (km1 + km2) / 2
        pm = exec_ms(lambda: pallas_sort.sort_rows_plain(x), 2)
        nb, ops = sort_work(R_x, F_x)
        bm, by = bound_ms(nb, ops, INT32_OPS_PER_S)
        unranked = float((x == 2**31 - 1).float().mean())
        log(f"# sort rows [{R_x}, {F_x}] (INT32_MAX share {unranked:.3f}): "
            f"kernel {km1:.4f} / {km2:.4f} ms, torch.sort {lm:.4f} ms, plain "
            f"{pm:.3f} ms, bound {bm:.4f} ms ({by}), share of bound "
            f"{bm / km:.3f}")
        t["ms"] += km
        t["plain_ms"] += pm
        t["library_ms"] += lm
        nb_t += nb
        ops_t += ops
    t["bound_ms"], t["bound_by"] = bound_ms(nb_t, ops_t, INT32_OPS_PER_S)
    t["bound_share"] = t["bound_ms"] / t["ms"]
    log(f"# row_sort per {what} ({len(xs)} launches): kernel "
        f"{t['ms']:.4f} ms, plain {t['plain_ms']:.3f} ms, torch.sort "
        f"{t['library_ms']:.4f} ms, bound {t['bound_ms']:.4f} ms "
        f"({t['bound_by']}; {nb_t / 1e6:.1f} MB at "
        f"{HBM_BYTES_PER_S / 1e12:.2f} TB/s, {ops_t / 1e9:.3f} G compares at "
        f"{INT32_OPS_PER_S / 1e12:.1f} T/s int32 issue rate), share of bound "
        f"{t['bound_share']:.3f}")
    return t


def time_cluster(torch, pallas_sort, xs, what, block=None, parent=None,
                 reps=20):
    """The cluster kernel (``block`` forcing its slice size), torch.sort
    and the kernel again on each input of ``xs``, then (with its default
    shape) its plain version, timed with CUDA events and summed, beside
    the card's bound for the same work, its cluster size and
    cudaOccupancyMaxActiveClusters, and with ``parent`` the parent
    commit's whole long-row sort of those rows."""
    t = dict(ms=0.0, plain_ms=0.0 if block is None else None,
             library_ms=0.0)
    nb_t = ops_t = 0.0
    for x in xs:
        km1 = exec_ms(lambda: pallas_sort.cluster_sort(x, block), reps)
        t["library_ms"] += exec_ms(lambda: torch.sort(x, dim=1), reps)
        km2 = exec_ms(lambda: pallas_sort.cluster_sort(x, block), reps)
        t["ms"] += (km1 + km2) / 2
        if block is None:
            t["plain_ms"] += exec_ms(
                lambda: pallas_sort.cluster_sort_plain(x), 1)
        nb, ops = sort_work(*x.shape)
        nb_t += nb
        ops_t += ops
    t["bound_ms"], t["bound_by"] = bound_ms(nb_t, ops_t, INT32_OPS_PER_S)
    t["bound_share"] = t["bound_ms"] / t["ms"]
    C, G, act, smem = pallas_sort.cluster_occupancy(*xs[0].shape, block)
    t.update(ctas=C, chunk=G, active_clusters=act, smem_bytes=smem)
    real = sum(int((x != 2**31 - 1).sum()) for x in xs)
    log(f"# cluster_sort per {what}: rows {[list(x.shape) for x in xs]}, "
        f"real-key share {real / (nb_t / 8):.3f}; {C} CTAs a row, chunks "
        f"of {G}, {smem} shared bytes a CTA, {act} active clusters "
        f"(cudaOccupancyMaxActiveClusters); kernel {t['ms']:.4f} ms, "
        f"torch.sort {t['library_ms']:.4f} ms, plain {t['plain_ms']} ms, "
        f"bound {t['bound_ms']:.4f} ms ({t['bound_by']}), share of bound "
        f"{t['bound_share']:.3f}")
    if parent:
        t["parent_ms"] = PARENT_LONG_SORT_MS[parent]
        log(f"# cluster_sort per {what}: the parent commit's whole long-row "
            f"sort of {parent}'s rows took {t['parent_ms']} ms "
            f"(time_long_sort.py): {t['parent_ms'] / t['ms']:.2f}x the "
            f"kernel's time")
    return t


def _plain_sort(pallas_sort, x):
    """The plain version of the kernel that sorts rows like ``x``."""
    if x.shape[1] <= pallas_sort._BLOCK_MAX:
        return pallas_sort.sort_rows_plain(x)
    return pallas_sort.cluster_sort_plain(x)


def _open_rows(torch, rng, B, F, dev):
    """[B, F] i32 rows like the banded stage 1's at +-0.5 Da fragments:
    open keys ((2^25 - pep) << 5) | z of about 4,000 peptides a row
    packed at the front, up to 8,700 of them (its largest count), then
    INT32_MAX."""
    n = rng.integers(0, 8700, size=B)
    pep = rng.integers(0, 1_700_000, size=(B, 1)) + rng.integers(
        0, 4000, size=(B, F))
    x = (((2**25 - pep) << 5) | rng.integers(1, 4, size=(B, F))).astype(
        np.int32)
    x[np.arange(F)[None, :] >= n[:, None]] = 2**31 - 1
    return torch.from_numpy(x).to(dev)


def _edge_keys(torch, rng, kind, B, F, dev):
    """[B, F] i32 rows: the full int32 range with INT32_MIN, -1, 0 and
    INT32_MAX in every row, or every row one repeated key."""
    if kind == "equal":
        x = np.full((B, F), rng.integers(-(2**31), 2**31), np.int32)
    else:
        x = rng.integers(-(2**31), 2**31, size=(B, F)).astype(np.int32)
        x[:, rng.choice(F, 4, replace=False)] = np.array(
            [-(2**31), -1, 0, 2**31 - 1], np.int32)
    return torch.from_numpy(x).to(dev)


def _enc(arr, dtype):
    return base64.b64encode(
        zlib.compress(np.ascontiguousarray(arr, dtype).tobytes())).decode()


def write_mzml(path, spectra, proton):
    """Processed spectra as an mzML file of MS2 scans: peaks at m/z =
    neutral mass + proton (charge 1), the precursor m/z and charge, the
    scan start time in minutes."""
    with open(path, "w") as f:
        f.write('<?xml version="1.0"?><mzML><run><spectrumList>')
        for s in spectra:
            prec = s.precursors[0]
            mz = s.masses.astype(np.float64) + float(proton)
            f.write(
                f'<spectrum id="{s.id}">'
                '<cvParam accession="MS:1000511" value="2"/>'
                '<cvParam accession="MS:1000127" value=""/>'
                '<cvParam accession="MS:1000285" '
                f'value="{float(s.intensities.sum())}"/>'
                "<scanList><scan>"
                f'<cvParam accession="MS:1000016" value="{s.scan_start_time}"'
                ' unitAccession="UO:0000031"/>'
                "</scan></scanList><precursorList><precursor>"
                "<selectedIonList><selectedIon>"
                f'<cvParam accession="MS:1000744" value="{prec.mz!r}"/>'
                f'<cvParam accession="MS:1000041" value="{prec.charge}"/>'
                "</selectedIon></selectedIonList></precursor>"
                "</precursorList><binaryDataArrayList>"
                '<binaryDataArray><cvParam accession="MS:1000523" value=""/>'
                '<cvParam accession="MS:1000574" value=""/>'
                '<cvParam accession="MS:1000514" value=""/>'
                f"<binary>{_enc(mz, np.float64)}</binary></binaryDataArray>"
                '<binaryDataArray><cvParam accession="MS:1000521" value=""/>'
                '<cvParam accession="MS:1000574" value=""/>'
                '<cvParam accession="MS:1000515" value=""/>'
                f"<binary>{_enc(s.intensities, np.float32)}</binary>"
                "</binaryDataArray></binaryDataArrayList></spectrum>"
            )
        f.write("</spectrumList></run></mzML>")


def write_mgf(path, spectra, proton):
    """Processed spectra as an MGF file (peaks as in :func:`write_mzml`)."""
    lines = []
    for s in spectra:
        prec = s.precursors[0]
        lines += ["BEGIN IONS", f"TITLE={s.id}", f"PEPMASS={prec.mz!r}",
                  f"CHARGE={prec.charge}+",
                  f"RTINSECONDS={60.0 * s.scan_start_time!r}"]
        lines += [f"{float(m) + float(proton)!r} {float(v)!r}"
                  for m, v in zip(s.masses, s.intensities)]
        lines.append("END IONS")
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")


def search_config(fasta, paths, **extra):
    """bench.py's database and tolerances as a search config."""
    return {
        "database": {"fasta": fasta, "static_mods": {"C": 57.0215},
                     "variable_mods": {"M": [15.9949]},
                     "generate_decoys": True},
        "precursor_tol": {"ppm": [-20, 20]},
        "fragment_tol": {"ppm": [-10, 10]},
        "deisotope": False, "write_pin": True, "mzml_paths": list(paths),
        **extra,
    }


def runner_phase(torch, pallas_stage1, tmp, times):
    """Phase 11: the Runner on bench.py's database and 16,384 of its
    spectra. Returns the record, the Runner (phases 20 and 21 run it
    again) and bench.py's 3 x 8192 synthetic spectra."""
    from sage_tpu_torch.bench_baseline import synth_fasta, synth_spectra
    from sage_tpu_torch.chem.mass import PROTON
    from sage_tpu_torch.pipeline.input import build_search
    from sage_tpu_torch.pipeline.output import OutputWriter
    from sage_tpu_torch.pipeline.runner import SCORE_BATCH, Runner

    n_spec = 2 * SCORE_BATCH
    with Phase("11_runner", times):
        fasta = os.path.join(tmp, "bench.fasta")
        with open(fasta, "w") as f:
            f.write(synth_fasta(PROTEINS))
        mzml = os.path.join(tmp, "bench.mzML")
        out_dir = os.path.join(tmp, "runner_out")
        search = build_search(search_config(fasta, [mzml]),
                              output_directory=out_dir)
        t0 = time.perf_counter()
        runner = Runner(search)
        db = runner.database
        log(f"# db: {PROTEINS} proteins, {len(db)} peptides, "
            f"{db.num_fragments} fragments, built by the Runner in "
            f"{time.perf_counter() - t0:.2f} s")
        spectra = synth_spectra(db, 3 * 8192)
        t0 = time.perf_counter()
        write_mzml(mzml, spectra[8192:8192 + n_spec], PROTON)
        log(f"# mzML: {n_spec} spectra, {os.path.getsize(mzml) / 2**20:.1f} "
            f"MiB, written in {time.perf_counter() - t0:.2f} s")

        trescore = rescore_mod()
        tprep = prep_mod()
        torch.cuda.reset_peak_memory_stats()
        pallas_stage1.launches = 0
        trescore.launches = 0
        tprep.launches = 0
        t0 = time.perf_counter()
        result = runner.run()
        torch.cuda.synchronize()
        run_s = time.perf_counter() - t0
        launches = pallas_stage1.launches
        r_launches = trescore.launches
        p_launches = tprep.launches
        peak_gib = torch.cuda.max_memory_allocated() / 2**30
        ph = result["phases"]
        log(f"# Runner phases (s): {ph}")
        log(f"# Runner: {n_spec} spectra, run() {run_s:.2f} s = "
            f"{n_spec / run_s:.1f} spectra/s whole run; search "
            f"{ph['search_s']:.3f} s = {n_spec / ph['search_s']:.1f} "
            f"spectra/s; stage1_counts launches {launches}, rescore "
            f"{r_launches}, batch_prep {p_launches}; peak device memory "
            f"{peak_gib:.2f} GiB")
        log(f"# Runner at 1% FDR: {result['q_spectrum']} PSMs, "
            f"{result['q_peptide']} peptides, {result['q_protein']} "
            f"proteins, {result['q_protein_group']} protein groups; "
            f"{len(result['features'])} PSMs reported")
        assert launches > 0, "the Runner did not launch the stage-1 kernel"
        assert r_launches > 0, "the Runner did not launch the rescore kernel"
        assert p_launches > 0, "the Runner did not launch batch_prep"
        with open(os.path.join(out_dir, "results.sage.tsv")) as f:
            header = f.readline().rstrip("\n").split("\t")
            n_rows = sum(1 for _ in f)
        assert header == OutputWriter.FEATURE_HEADERS, header
        assert n_rows == len(result["features"]) > 0.9 * n_spec, n_rows
        # bench.py draws its spectra from targets and decoys alike, so
        # about half the top PSMs are decoys and few pass 1% FDR; each
        # spectrum carries its peptide's precursor mass
        c = result["features"].columns
        near = float((np.abs(c["delta_mass"]) <= 20.5).mean())
        decoys = float((c["label"] == -1).mean())
        assert near > 0.9, near
        log(f"# results.sage.tsv: the {len(header)} OutputWriter columns, "
            f"{n_rows} rows; {near:.3f} of the PSMs within 20 ppm of their "
            f"precursor, decoy share {decoys:.3f}")
    rec = dict(spectra=n_spec, run_s=run_s, phases=ph,
               whole_run_spectra_per_s=n_spec / run_s,
               search_spectra_per_s=n_spec / ph["search_s"],
               stage1_launches=launches, rescore_launches=r_launches,
               prep_launches=p_launches, peak_device_gib=peak_gib,
               q_spectrum=result["q_spectrum"], q_peptide=result["q_peptide"],
               q_protein=result["q_protein"],
               q_protein_group=result["q_protein_group"],
               psms_within_20ppm=near, decoy_share=decoys)
    return rec, runner, spectra


def host_packages_phase(times):
    """Phase 0: whether the host packages that the .d reader (a zstd
    codec) and the parquet writer (pyarrow) import are present."""
    import importlib

    found = {}
    with Phase("0_host_packages", times):
        for name in ("pyarrow", "zstandard", "compression.zstd"):
            try:
                mod = importlib.import_module(name)
                found[name] = getattr(mod, "__version__", "present")
            except ImportError:
                found[name] = None
        log("# host packages: " + ", ".join(
            f"{k} {v or 'absent'}" for k, v in found.items()))
    return found


def rerun(runner, search, out_dir, **changes):
    """Run phase 11's Runner again on ``changes`` of its parameters: a
    fresh output list and directory, its start time reset and the
    result's phases this call's alone (``run()`` keeps no other state
    between calls)."""
    import dataclasses

    os.makedirs(out_dir, exist_ok=True)
    runner.parameters = dataclasses.replace(
        search, output_directory=out_dir, output_paths=[], **changes)
    runner.start = time.monotonic()
    before = runner.phases
    result = runner.run()
    result["phases"] = {k: round(v - before.get(k, 0.0), 3)
                        for k, v in runner.phases.items()}
    return result


def tdf_phase(torch, pallas_stage1, runner, spectra, tmp, pyarrow, times):
    """Phase 20: phase 11's 16,384 spectra as a synthetic ddaPASEF .d
    through phase 11's Runner (parquet output when pyarrow imports),
    then its first 512 precursors as their own .d on the card and on the
    CPU."""
    import copy

    from sage_tpu_torch.bench_baseline import synth_tdf
    from sage_tpu_torch.pipeline.runner import SCORE_BATCH

    n_spec = 2 * SCORE_BATCH
    search = runner.parameters
    out_name = "results.sage.parquet" if pyarrow else "results.sage.tsv"
    rec = dict(parquet="run" if pyarrow else "not run: pyarrow absent")
    with Phase("20_runner_tdf", times):
        if not pyarrow:
            log("# phase 20: pyarrow absent, so the parquet half does not "
                "run; the .d half writes TSV")
        d = os.path.join(tmp, "bench.d")
        t0 = time.perf_counter()
        synth_tdf(d, spectra[8192:8192 + n_spec])
        log(f"# .d: {n_spec} precursors, 10 a frame, 2 PASEF frames each, "
            f"MS1 frames between; {os.path.getsize(d + '/analysis.tdf_bin') / 2**20:.1f} "
            f"MiB of frames written in {time.perf_counter() - t0:.2f} s")
        out_dir = os.path.join(tmp, "tdf_out")
        trescore = rescore_mod()
        tprep = prep_mod()
        pallas_stage1.launches = 0
        trescore.launches = 0
        tprep.launches = 0
        t0 = time.perf_counter()
        result = rerun(runner, search, out_dir, mzml_paths=[d],
                       parquet=bool(pyarrow))
        torch.cuda.synchronize()
        run_s = time.perf_counter() - t0
        launches = pallas_stage1.launches
        r_launches = trescore.launches
        p_launches = tprep.launches
        ph = result["phases"]
        c = result["features"].columns
        near = float((np.abs(c["delta_mass"]) <= 20.5).mean())
        log(f"# Runner on the .d: {n_spec} spectra, run() {run_s:.2f} s = "
            f"{n_spec / run_s:.1f} spectra/s whole run; read (TDF reader) "
            f"{ph['read_s']:.3f} s; search {ph['search_s']:.3f} s = "
            f"{n_spec / ph['search_s']:.1f} spectra/s; write {ph['write_s']:.3f}"
            f" s ({out_name}); stage1_counts launches {launches}, rescore "
            f"{r_launches}, batch_prep {p_launches}; "
            f"{result['q_spectrum']} PSMs at 1% FDR; "
            f"{near:.3f} of the PSMs "
            f"within 20 ppm; ion mobility {float(c['ims'].min()):.3f}-"
            f"{float(c['ims'].max()):.3f}; phases {ph}")
        assert launches > 0, "the .d run did not launch the stage-1 kernel"
        assert r_launches > 0, "the .d run did not launch the rescore kernel"
        assert p_launches > 0, "the .d run did not launch batch_prep"
        assert near > 0.9, near
        assert os.path.exists(os.path.join(out_dir, out_name))
        if pyarrow:
            assert not os.path.exists(os.path.join(out_dir,
                                                   "results.sage.tsv"))
        rec.update(spectra=n_spec, run_s=run_s, phases=ph,
                   whole_run_spectra_per_s=n_spec / run_s,
                   search_spectra_per_s=n_spec / ph["search_s"],
                   read_s=ph["read_s"], write_s=ph["write_s"],
                   stage1_launches=launches, rescore_launches=r_launches,
                   prep_launches=p_launches,
                   q_spectrum=result["q_spectrum"], psms=len(c["ims"]),
                   psms_within_20ppm=near)
        rec.update(ms1_read(d))

        # the first 512 precursors: card against CPU, the same database
        small = os.path.join(tmp, "small.d")
        synth_tdf(small, spectra[8192:8192 + 512])
        outs = {}
        cpu_runner = copy.copy(runner)
        cpu_runner.device = torch.device("cpu")
        for dev, r in (("card", runner), ("cpu", cpu_runner)):
            outs[dev] = os.path.join(tmp, f"small_{dev}")
            t0 = time.perf_counter()
            rerun(r, search, outs[dev], mzml_paths=[small],
                  parquet=bool(pyarrow))
            rec[f"small_{dev}_s"] = time.perf_counter() - t0
        with open(os.path.join(outs["card"], out_name), "rb") as a, \
                open(os.path.join(outs["cpu"], out_name), "rb") as b:
            got = a.read()
            assert got == b.read(), f"{out_name}: card and CPU differ"
        log(f"# 512 precursors as their own .d: {out_name} byte-equal on "
            f"the card ({rec['small_card_s']:.1f} s) and the CPU "
            f"({rec['small_cpu_s']:.1f} s), {len(got)} bytes")
    runner.parameters = search
    return rec


def ms1_read(d):
    """The TDF reader on the .d without and with MS1 (``requires_ms1``, as
    ``quant.lfq`` asks): the second runs ``fast_centroid`` on every MS1
    frame, timed on its own through a wrapper."""
    from sage_tpu_torch.io import tdf
    from sage_tpu_torch.io.cloudpath import read_spectra

    t0 = time.perf_counter()
    ms2 = read_spectra(d)
    ms2_s = time.perf_counter() - t0
    plain, spent, peaks = tdf.fast_centroid, [0.0], [0]

    def timed(mz, *args, **kwargs):
        t = time.perf_counter()
        out = plain(mz, *args, **kwargs)
        spent[0] += time.perf_counter() - t
        peaks[0] += len(mz)
        return out

    tdf.fast_centroid = timed
    try:
        t0 = time.perf_counter()
        both = read_spectra(d, requires_ms1=True)
        both_s = time.perf_counter() - t0
    finally:
        tdf.fast_centroid = plain
    ms1 = [s for s in both if s.ms_level == 1]
    assert len(ms1) > 0 and len(both) - len(ms1) == len(ms2)
    log(f"# TDF reader on the .d: MS2 only {ms2_s:.3f} s; with MS1 "
        f"{both_s:.3f} s, of which fast_centroid {spent[0]:.3f} s on "
        f"{len(ms1)} MS1 frames ({peaks[0]} peaks in, "
        f"{sum(len(s.mz) for s in ms1)} out; the synthetic frames are "
        f"sparse)")
    return dict(read_ms2_only_s=ms2_s, read_with_ms1_s=both_s,
                fast_centroid_s=spent[0], ms1_frames=len(ms1),
                ms1_peaks_in=peaks[0])


def multiprocess_phase(torch, pallas_stage1, runner, spectra, tmp, times):
    """Phase 21: phase 11's spectra as 3 mzML files, searched by two
    ``python -m sage_tpu_torch`` processes on the one card (gloo over
    localhost) and by phase 11's Runner in this process; the two
    results.sage.tsv must be byte-equal, process 1 must write nothing and
    both processes must launch the stage-1 kernel."""
    import re
    import socket

    from sage_tpu_torch.chem.mass import PROTON
    from sage_tpu_torch.pipeline.runner import SCORE_BATCH

    n_spec = 2 * SCORE_BATCH
    search = runner.parameters
    rec = {}
    with Phase("21_multiprocess", times):
        part = -(-n_spec // 3)
        paths = []
        for i in range(3):
            paths.append(os.path.join(tmp, f"part{i}.mzML"))
            lo = 8192 + i * part
            write_mzml(paths[-1], spectra[lo:min(lo + part, 8192 + n_spec)],
                       PROTON)
        cfg = search_config(search.database.fasta, paths)
        cfg_path = os.path.join(tmp, "mp.json")
        with open(cfg_path, "w") as f:
            json.dump(cfg, f)
        with socket.socket() as sk:
            sk.bind(("127.0.0.1", 0))
            port = sk.getsockname()[1]
        root = os.path.dirname(os.path.abspath(__file__))
        procs, logs = [], []
        t0 = time.perf_counter()
        for rank in range(2):
            # each process's log goes to a file: the pipes stay unread
            # while this process runs its own search
            logs.append(open(os.path.join(tmp, f"mp_rank{rank}.log"),
                             "w+"))
            env = dict(os.environ)
            env["PYTHONPATH"] = os.pathsep.join(
                [root] + [p for p in env.get("PYTHONPATH", "").split(
                    os.pathsep) if p])
            env.update(SAGE_TPU_COORDINATOR=f"127.0.0.1:{port}",
                       SAGE_TPU_NUM_PROCS="2", SAGE_TPU_PROC_ID=str(rank))
            procs.append(subprocess.Popen(
                [sys.executable, "-m", "sage_tpu_torch", cfg_path, "-o",
                 os.path.join(tmp, f"mp_rank{rank}"),
                 "--disable-telemetry-i-dont-want-to-improve-sage"],
                cwd=root, env=env, stdout=logs[-1],
                stderr=subprocess.STDOUT))
        try:
            # one process, here, while the two build their databases
            single = os.path.join(tmp, "mp_single")
            pallas_stage1.launches = 0
            t1 = time.perf_counter()
            rerun(runner, search, single, mzml_paths=paths)
            rec["single_s"] = time.perf_counter() - t1
            rec["single_stage1_launches"] = pallas_stage1.launches
            runner.parameters = search
            for p in procs:
                p.wait(timeout=600)
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        rec["processes_s"] = time.perf_counter() - t0
        outs = []
        for f in logs:
            f.seek(0)
            outs.append(f.read())
            f.close()
        for rank, (p, err) in enumerate(zip(procs, outs)):
            if p.returncode != 0:
                log(err[-4000:])
            assert p.returncode == 0, f"process {rank} exited {p.returncode}"
        launches, gather, db_s = [], [], []
        for rank, err in enumerate(outs):
            m = re.search(r"kernel launches: stage1_counts=(\d+)", err)
            g = re.search(r"phase seconds: .*\bgather=([0-9.]+)", err)
            b = re.search(r"phase seconds: db_build=([0-9.]+)", err)
            assert m and g and b, err[-4000:]
            launches.append(int(m.group(1)))
            gather.append(float(g.group(1)))
            db_s.append(float(b.group(1)))
        assert all(n > 0 for n in launches), launches
        assert rec["single_stage1_launches"] > 0
        assert os.listdir(os.path.join(tmp, "mp_rank1")) == []
        name = "results.sage.tsv"
        with open(os.path.join(tmp, "mp_rank0", name), "rb") as a, \
                open(os.path.join(single, name), "rb") as b:
            got = a.read()
            assert got == b.read(), f"{name}: 2 processes and 1 differ"
        rec.update(stage1_launches=launches, gather_s=gather,
                   db_build_s=db_s, rows=got.count(b"\n") - 1)
        log(f"# two processes on the card over 3 files: both exit 0 in "
            f"{rec['processes_s']:.1f} s (each builds its database: "
            f"{db_s} s); stage1_counts launches {launches}; the gather "
            f"{gather} s; results.sage.tsv byte-equal to one process in "
            f"this one ({rec['single_s']:.1f} s, {rec['rows']} rows); "
            f"process 1 wrote nothing")
    return rec


def cli_phase(torch, tmp, times):
    """Phase 12: ``python -m sage_tpu_torch`` on the card against the
    Runner on the CPU."""
    from sage_tpu_torch.bench_baseline import synth_fasta, synth_spectra
    from sage_tpu_torch.chem.fasta import Fasta
    from sage_tpu_torch.chem.mass import PROTON
    from sage_tpu_torch.pipeline.input import build_search
    from sage_tpu_torch.pipeline.runner import Runner

    with Phase("12_cli", times):
        text = synth_fasta(300, seed=3)
        fasta = os.path.join(tmp, "cli.fasta")
        with open(fasta, "w") as f:
            f.write(text)
        cfg = search_config(fasta, [os.path.join(tmp, "cli.mgf")])
        dbp = build_search(cfg, output_directory=tmp).database
        db = dbp.build(Fasta.parse(text, dbp.decoy_tag, dbp.generate_decoys))
        write_mgf(cfg["mzml_paths"][0], synth_spectra(db, 512, seed=13),
                  PROTON)
        cfg_path = os.path.join(tmp, "cli.json")
        with open(cfg_path, "w") as f:
            json.dump(cfg, f)
        root = os.path.dirname(os.path.abspath(__file__))
        env = dict(os.environ)
        env["PYTHONPATH"] = os.pathsep.join(
            [root] + [p for p in env.get("PYTHONPATH", "").split(os.pathsep)
                      if p])
        out_card = os.path.join(tmp, "cli_card")
        t0 = time.perf_counter()
        r = subprocess.run(
            [sys.executable, "-m", "sage_tpu_torch", cfg_path, "-o", out_card],
            cwd=root, env=env, capture_output=True, text=True, timeout=600,
        )
        cli_s = time.perf_counter() - t0
        if r.returncode != 0:
            log(r.stdout[-4000:])
            log(r.stderr[-4000:])
        assert r.returncode == 0, f"the CLI exited {r.returncode}"
        out_cpu = os.path.join(tmp, "cli_cpu")
        t0 = time.perf_counter()
        Runner(build_search(json.loads(json.dumps(cfg)),
                            output_directory=out_cpu), device="cpu").run()
        cpu_s = time.perf_counter() - t0
        n_rows = 0
        for name in ("results.sage.tsv", "results.sage.pin"):
            with open(os.path.join(out_card, name), "rb") as a, \
                    open(os.path.join(out_cpu, name), "rb") as b:
                got = a.read()
                assert got == b.read(), f"{name}: card and CPU differ"
            n_rows = max(n_rows, got.count(b"\n") - 1)
        assert n_rows > 256, n_rows
        log(f"# CLI on the card: exit 0 in {cli_s:.1f} s (its own process, "
            f"kernel build included); results.sage.tsv and results.sage.pin "
            f"byte-equal to the CPU Runner's ({n_rows} rows; CPU run "
            f"{cpu_s:.1f} s)")
    return dict(cli_s=cli_s, cpu_runner_s=cpu_s, rows=n_rows)


def _grid(torch, sharding, db, params, shape, dev):
    """A ShardedScorer on a ``shape`` grid whose shards all lie on ``dev``
    (listed data x model times), and its build seconds."""
    mesh = sharding.make_mesh(*shape, devices=[dev] * (shape[0] * shape[1]))
    t0 = time.perf_counter()
    sc = sharding.ShardedScorer(db, mesh, params)
    torch.cuda.synchronize()
    return sc, time.perf_counter() - t0


def sharded_phases(torch, mods, db, narrow_fused, open_fused, dev, times):
    """Phases 22-23: the grid's narrow (windowed) and banded open steps,
    every shard on this card. Returns the record."""
    from sage_tpu_torch.parallel import sharding

    pallas_stage1, pallas_sort = mods["stage1"], mods["sort"]
    topen = mods["open"]
    trescore = rescore_mod()
    # the grid keeps the host's prep: no batch_prep launch in 22-23
    tprep = prep_mod()
    tprep.launches = 0
    rec = {"narrow": {}, "open": {}, "rescore_launches": 0}
    with Phase("22_sharded_narrow", times):
        params, (b1, _b2), tables = narrow_fused
        captured = []
        real_s1 = sharding.stage1_counts

        def recording(lad, peaks, ints, **kw):
            if len(captured) < 2:
                captured.append((lad, peaks, ints, kw))
            return real_s1(lad, peaks, ints, **kw)

        launches = 0
        for shape in ((2, 2), (1, 4)):
            sc, build_s = _grid(torch, sharding, db, params, shape, dev)
            sc._host._psm_counter = int(tables[0].columns["psm_id"][0])
            sharding.stage1_counts = recording
            pallas_stage1.launches = 0
            trescore.launches = 0
            t0 = time.perf_counter()
            try:
                t = sc.score_table(b1)
                torch.cuda.synchronize()
            finally:
                sharding.stage1_counts = real_s1
            wall = time.perf_counter() - t0
            n = pallas_stage1.launches
            n_r = trescore.launches
            rec["rescore_launches"] += n_r
            assert sc.last_route[0] == "win", sc.last_route
            assert n > 0, f"grid {shape}: the stage-1 kernel did not launch"
            assert n_r > 0, f"grid {shape}: the rescore kernel did not launch"
            assert_tables_equal(t, tables[0], f"sharded narrow {shape}")
            launches += n
            log(f"# sharded narrow {shape}: {len(b1)} spectra in {wall:.3f} "
                f"s = {len(b1) / wall:.1f} spectra/s (the {shape[0] * shape[1]}"
                f" shards share the card and run one after another), tables "
                f"built in {build_s:.2f} s, P_local "
                f"{sc.search.tables.P_local}, step {sc.last_route}, "
                f"stage1_counts launches {n}, rescore {n_r}, most live "
                f"items a shard rescored {sc.search.last_live}; all "
                f"{len(t.columns)} columns equal phase 3's")
            rec["narrow"][f"{shape[0]}x{shape[1]}"] = dict(
                wall_s=wall, spectra_per_s=len(b1) / wall, build_s=build_s,
                stage1_launches=n, rescore_launches=n_r, W=sc.last_route[1],
                last_live=sc.search.last_live)
        rec["stage1_launches"] = launches
        for lad, peaks, ints, kw in captured:
            got = pallas_stage1.stage1_counts(lad, peaks, ints, **kw)
            want = pallas_stage1.stage1_counts_plain(lad, peaks, ints, **kw)
            torch.cuda.synchronize()
            assert torch.equal(got, want), kw
        log(f"# sharded narrow: the stage-1 kernel equals its plain version "
            f"at {len(captured)} of the grid's launches (rows "
            f"{[c[2].shape[1] for c in captured]}, W "
            f"{[c[3]['W'] for c in captured]})")

    with Phase("23_sharded_open", times):
        params, batches, tables = open_fused
        batches = batches[:GRID_OPEN_BATCHES]
        n_spec = sum(len(b) for b in batches)
        sorts = {}
        real_sort = topen.bitonic_sort_rows

        def recording_sort(key, *a, **k):
            kind = "row_sort" if key.shape[1] <= pallas_sort._BLOCK_MAX \
                else "cluster_sort"
            sorts.setdefault(kind, key[:128].clone())
            return real_sort(key, *a, **k)

        totals = {k: 0 for k in pallas_sort.launches}
        peak_totals = {k: 0 for k in topen.launches}
        # a -500/+100 Da window spans no more than one shard's peptide
        # range at a model axis of 2, where the windowed step's gate would
        # take it: the banded open step is asked for, as sage_tpu's tests
        # ask for it
        for shape in GRID_OPEN_SHAPES:
            sc, build_s = _grid(torch, sharding, db, params, shape, dev)
            n_shards = shape[0] * shape[1]
            per_batch = []
            for k in pallas_sort.launches:
                pallas_sort.launches[k] = 0
            trescore.launches = 0
            reset_peak(topen)
            t0 = time.perf_counter()
            with EnvSet("SAGE_TPU_SHARD_WINDOWED", "0"):
                topen.bitonic_sort_rows = recording_sort
                try:
                    for bt, tt in zip(batches, tables):
                        n0 = dict(pallas_sort.launches)
                        sc._host._psm_counter = int(tt.columns["psm_id"][0])
                        t = sc.score_table(bt)
                        kind, B, F = sc.last_route
                        assert kind == "open", sc.last_route
                        grew = {k: pallas_sort.launches[k] - n0[k]
                                for k in n0}
                        # rows past MAX_F keys take torch.sort, as on one
                        # device
                        want = ("row_sort" if F <= pallas_sort._BLOCK_MAX
                                else "cluster_sort" if F <= pallas_sort.MAX_F
                                else "torch.sort")
                        assert grew == {k: n_shards * (k == want)
                                        for k in grew}, (shape, F, grew)
                        assert_tables_equal(t, tt, f"sharded open {shape}")
                        per_batch.append((F, want))
                    torch.cuda.synchronize()
                finally:
                    topen.bitonic_sort_rows = real_sort
            wall = time.perf_counter() - t0
            launches = dict(pallas_sort.launches)
            n_r = trescore.launches
            peak = dict(topen.launches)
            rec["rescore_launches"] += n_r
            assert n_r > 0, f"grid {shape}: the rescore kernel did not launch"
            assert all(peak[k] > 0 for k in PEAK_KERNELS), peak
            for k in totals:
                totals[k] += launches[k]
            for k in peak_totals:
                peak_totals[k] += peak[k]
            # one batch's range planning over the shards (the range search
            # kernel and the fetch of its ranges)
            masses = sc._host._pad_peaks(batches[0])[0]
            t0 = time.perf_counter()
            sc.search.open_ranges(masses)
            plan_s = time.perf_counter() - t0
            log(f"# sharded open {shape}: {len(batches)} x {len(batches[0])} "
                f"spectra in {wall:.3f} s = {n_spec / wall:.1f} spectra/s "
                f"(shards share the card, one after another; the first "
                f"batch builds the shards' fragment index), tables built in "
                f"{build_s:.2f} s; B x F <= MAX_ELEMENTS, so the banded open "
                f"step each batch; (F, sort) per batch {per_batch}; launches "
                f"{launches}, rescore {n_r}, {peak}; range planning "
                f"{plan_s:.3f} s a batch; all columns equal phase 6's")
            rec["open"][f"{shape[0]}x{shape[1]}"] = dict(
                wall_s=wall, spectra_per_s=n_spec / wall, build_s=build_s,
                F=[f for f, _k in per_batch], launches=launches,
                rescore_launches=n_r, peak_launches=peak,
                plan_s=plan_s)
        rec["sort_launches"] = totals
        rec["peak_launches"] = peak_totals
        assert totals["row_sort"] > 0 and totals["cluster_sort"] > 0, totals
        for kind, x in sorts.items():
            got = real_sort(x)
            torch.cuda.synchronize()
            assert torch.equal(got.cpu(), _plain_sort(pallas_sort, x.cpu()))
            log(f"# sharded open: {kind} equals its plain version on a "
                f"[{x.shape[0]}, {x.shape[1]}] slice of the grid's rows")
    rec["prep_launches"] = tprep.launches
    assert rec["prep_launches"] == 0, "the grid launched batch_prep"
    return rec


def sharded_runner_phase(torch, pallas_stage1, runner, search, tsv11, tmp,
                         dev, times):
    """Phase 24: phase 11's Runner and spectra on a (2, 2) grid, every
    shard on ``dev``; results.sage.tsv byte-equal to phase 11's."""
    from sage_tpu_torch.parallel import sharding

    out_dir = os.path.join(tmp, "runner_grid")
    with Phase("24_sharded_runner", times):
        kinds = []
        real_local, real_make = sharding.local_devices, runner._make_scorer

        def make():
            s = real_make()
            kinds.append(type(s).__name__)
            return s

        sharding.local_devices = lambda device="cuda": [dev] * 4
        runner._make_scorer = make
        trescore = rescore_mod()
        tprep = prep_mod()
        pallas_stage1.launches = 0
        trescore.launches = 0
        tprep.launches = 0
        t0 = time.perf_counter()
        try:
            result = rerun(runner, search, out_dir, mesh_shape=(2, 2))
            torch.cuda.synchronize()
        finally:
            sharding.local_devices = real_local
            del runner._make_scorer
        run_s = time.perf_counter() - t0
        launches = pallas_stage1.launches
        r_launches = trescore.launches
        p_launches = tprep.launches
        with open(os.path.join(out_dir, "results.sage.tsv"), "rb") as f:
            tsv = f.read()
        assert kinds == ["ShardedScorer"], kinds
        assert p_launches == 0, "the grid Runner launched batch_prep"
        assert launches > 0, "the grid Runner did not launch stage 1"
        assert r_launches > 0, "the grid Runner did not launch the rescore"
        assert tsv == tsv11, "grid results.sage.tsv differs from phase 11's"
        ph = result["phases"]
        n_spec = len(result["features"])
        log(f"# sharded Runner (2, 2) on one card: run() {run_s:.2f} s, "
            f"search {ph['search_s']:.3f} s; stage1_counts launches "
            f"{launches}, rescore {r_launches}; results.sage.tsv "
            f"({len(tsv)} bytes, {n_spec} PSMs) byte-equal to phase 11's")
    return dict(run_s=run_s, phases=ph, stage1_launches=launches,
                rescore_launches=r_launches, prep_launches=p_launches)


def two_dispatch_phase(torch, tsearch, name, db, fused, kernel, counts,
                       times, open_search=False, capture=None,
                       peak_capture=None):
    """Phases 13 and 14: the batches of a fused main path, ``fused`` =
    (params, batches, tables), again with SAGE_TPU_FUSED=0; ``counts`` =
    (reset, read): ``read`` returns every launch counter the kernels line
    reports, as a dict, and ``kernel``'s and the rescore's must read > 0.
    All counters are read once, right after the stream and before the
    timed single batch. Every column must equal the fused tables; prints
    the wall rate and one batch's host phases. The open searcher's tables
    are built before the timed run, as phase 6 builds them. ``capture``:
    (dict, key) that takes the first batch's first rescore inputs, from
    one more untimed run of that batch; ``peak_capture``: (topen, dict)
    that takes, from that run too, the peak-major kernels' inputs at
    their widest nbcov, and the open searcher as ``searcher``."""
    params, batches, fused_tables = fused
    reset, read = counts
    sync = torch.cuda.synchronize
    n = sum(len(b) for b in batches)
    with Phase(name, times):
        os.environ["SAGE_TPU_FUSED"] = "0"
        try:
            scorer = tsearch.Scorer(db, params)
            if open_search:
                scorer._open_searcher()
            sync()
            # number the PSMs as the fused run did
            scorer._psm_counter = int(fused_tables[0].columns["psm_id"][0])
            reset()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            tables = list(scorer.score_stream(batches))
            sync()
            wall_s = time.perf_counter() - t0
            launches_all = dict(read())
            launches = launches_all[kernel]
            peak_gib = torch.cuda.max_memory_allocated() / 2**30
            assert launches > 0, f"{name}: {kernel} not launched"
            assert launches_all["rescore"] > 0, f"{name}: rescore not launched"
            for i, (a, b) in enumerate(zip(tables, fused_tables)):
                assert_tables_equal(a, b, f"{name} batch {i} vs fused")
            # one batch's host phases, each synchronised
            ph = {}

            def timed(key, fn):
                def call(*a, **k):
                    t = time.perf_counter()
                    out = fn(*a, **k)
                    sync()
                    ph[key] = ph.get(key, 0.0) + (time.perf_counter() - t) * 1e3
                    return out
                return call

            for key in ("_prelim_dispatch", "_prelim_finalize",
                        "_stage2_dispatch", "_stage2_finalize"):
                setattr(scorer, key, timed(key.strip("_") + "_ms",
                                           getattr(scorer, key)))
            t0 = time.perf_counter()
            scorer.score_table(batches[0])
            sync()
            ph["score_table_ms"] = (time.perf_counter() - t0) * 1e3
            if capture or peak_capture:
                # the first batch once more, untimed, for its rescore and
                # peak-major kernels' inputs
                with contextlib.ExitStack() as stack:
                    if capture:
                        stack.enter_context(capture_rescore(tsearch,
                                                            *capture))
                    if peak_capture:
                        topen_, store = peak_capture
                        store["searcher"] = scorer._open_searcher()
                        stack.enter_context(capture_peak(topen_, None, store,
                                                         widest=True))
                    scorer.score_table(batches[0])
                sync()
        finally:
            del os.environ["SAGE_TPU_FUSED"]
        log(f"# {name}: {len(batches)} x {len(batches[0])} spectra in "
            f"{wall_s:.3f} s wall = {n / wall_s:.1f} spectra/s; "
            f"launches {launches_all}; peak device memory "
            f"{peak_gib:.2f} GiB; all {len(fused_tables[0].columns)} "
            f"FeatureTable columns equal the fused tables "
            f"({sum(len(t) for t in tables)} PSMs)")
        log(f"# {name} one batch (ms, synchronised): "
            + ", ".join(f"{k} {v:.2f}" for k, v in ph.items()))
    return dict(wall_s=wall_s, spectra_per_s=n / wall_s, launches=launches,
                launches_all=launches_all, peak_device_gib=peak_gib,
                batch_phases_ms=ph)


class Recording:
    """Replace ``owner.attr`` with a wrapper that calls the real function
    and then ``keep(result, *args, **kwargs)``, until the block ends."""

    def __init__(self, owner, attr, keep):
        self.owner, self.attr, self.keep = owner, attr, keep

    def __enter__(self):
        self.real = real = getattr(self.owner, self.attr)

        def call(*a, **k):
            out = real(*a, **k)
            self.keep(out, *a, **k)
            return out

        setattr(self.owner, self.attr, call)
        return self

    def __exit__(self, *exc):
        setattr(self.owner, self.attr, self.real)


class EnvSet:
    """Set (or, with None, remove) an environment variable until the
    block ends, then restore it."""

    def __init__(self, name, value):
        self.name, self.value = name, value

    def __enter__(self):
        self.old = os.environ.get(self.name)
        if self.value is None:
            os.environ.pop(self.name, None)
        else:
            os.environ[self.name] = self.value
        return self

    def __exit__(self, *exc):
        if self.old is None:
            os.environ.pop(self.name, None)
        else:
            os.environ[self.name] = self.old


def banded_phase(torch, mods, db, spectra, times, name, frags,
                 cpu_spectra=0, lowres=False, capture=None, peak_in=None):
    """Phases 15 and 16: bench.py's spectra with a +-1.5 Da precursor
    window, which puts the batch's widest window at W = 4096, through the
    banded stage 1 (SAGE_TPU_NARROW_BANDED=1). A warm-up batch (phase
    3's) learns the entry capacity F, then phase 3's first batch runs with
    the launch counters set to 0 just before and read just after: the
    banded branch and the row-sort kernel, or with ``lowres`` the cluster
    kernel (once for each sort of rows past 2^15 keys, and no other
    kernel for those sorts), must launch. Every FeatureTable column must
    equal the same
    batch's with SAGE_TPU_NARROW_BANDED=0 (the candidate-major stage-1
    kernel at Wb = 4096) and with no environment variable (the auto
    gate, whose choice is checked). ``frags``: fragment tolerances in
    order of preference; with ``lowres`` the first whose F puts the entry
    rows past the one-pass limit is kept. ``cpu_spectra``: that many
    spectra on the card and on the CPU, every column equal. The sort
    kernels are then checked against their plain versions and torch.sort
    and timed at the inputs the batch gave them. The rescore counter is
    set to 0 with the others and must be > 0 after, as must the
    peak-major kernels' (range search, entry gather, run-count top-K);
    ``capture``: (dict, key) that takes the last tolerance's warm-up
    batch's first rescore inputs; ``peak_in``: a dict that takes the
    peak-major kernels' first inputs of the batch's untimed rerun."""
    tsearch, tbanded, topen, pallas_sort, pallas_stage1 = (
        mods["search"], mods["banded"], mods["open"], mods["sort"],
        mods["stage1"])
    sync = torch.cuda.synchronize
    B = BANDED_BATCH
    warm, batch = spectra[:B], spectra[B:2 * B]
    rec = {"batch": B}
    with Phase(name, times), EnvSet("SAGE_TPU_NARROW_BANDED", "1"):
        for frag in frags:
            params = tsearch.SearchParams(
                precursor_tol=tsearch.Tolerance(*BANDED_PREC),
                fragment_tol=tsearch.Tolerance(*frag))
            t0 = time.perf_counter()
            scorer = tsearch.Scorer(db, params)
            reruns0 = scorer.fused_reruns
            if capture:
                capture[0].pop(capture[1], None)
                with capture_rescore(tsearch, *capture):
                    list(scorer.score_stream([warm]))
            else:
                list(scorer.score_stream([warm]))
            sync()
            warm_s = time.perf_counter() - t0
            nb = scorer._nb
            assert nb is not None, f"{name}: the warm-up took no banded batch"
            log(f"# {name} fragment {frag}: scorer and warm-up batch in "
                f"{warm_s:.2f} s; {nb.n_bands} bands of {nb.band_w} "
                f"peptides, nstep {nb.nstep}, F {nb._F}")
            if not lowres or nb._F > pallas_sort._BLOCK_MAX:
                break
            log(f"# {name}: F {nb._F} keeps the entry rows within one "
                f"sort pass; next tolerance")
        assert not lowres or nb._F > pallas_sort._BLOCK_MAX, nb._F
        rec.update(fragment_tol=list(frag), n_bands=nb.n_bands,
                   band_w=nb.band_w)

        # the measured batch
        scorer._psm_counter = 1
        calls = []
        measured0 = scorer.fused_reruns
        trescore = rescore_mod()
        tprep = prep_mod()
        pallas_stage1.launches = 0
        for k in pallas_sort.launches:
            pallas_sort.launches[k] = 0
        trescore.launches = 0
        tprep.launches = 0
        reset_peak(topen)
        torch.cuda.reset_peak_memory_stats()
        with Recording(tbanded.NarrowBanded, "dispatch",
                       lambda out, *a, **k: calls.append(out)):
            t0 = time.perf_counter()
            tables = list(scorer.score_stream([batch]))
            sync()
            wall_s = time.perf_counter() - t0
        launches = dict(pallas_sort.launches)
        r_launches = trescore.launches
        p_launches = tprep.launches
        peak_launches = dict(topen.launches)
        peak_gib = torch.cuda.max_memory_allocated() / 2**30
        lp = dict(scorer.last_plan)
        totmax = [int(c[1].item()) for c in calls]
        reruns = scorer.fused_reruns - reruns0
        measured_reruns = scorer.fused_reruns - measured0
        log(f"# {name}: {B} spectra in {wall_s:.3f} s = {B / wall_s:.1f} "
            f"spectra/s; banded dispatches {len(calls)}, W {lp.get('W')}, "
            f"nbcov {[c[3] for c in calls]}, F {[c[2] for c in calls]}, "
            f"totmax {totmax}, overflow reruns in the phase {reruns} (in "
            f"the measured batch {measured_reruns}); "
            f"launches {launches}, stage1_counts {pallas_stage1.launches}, "
            f"rescore {r_launches}, batch_prep {p_launches}, "
            f"{peak_launches}; peak device memory "
            f"{peak_gib:.2f} GiB")
        assert calls and lp.get("banded"), f"{name}: no banded dispatch"
        assert p_launches == 1, f"{name}: batch_prep launches {p_launches}"
        assert r_launches > 0, f"{name}: the rescore kernel did not launch"
        assert all(peak_launches[k] > 0 for k in PEAK_KERNELS), peak_launches
        assert launches["row_sort" if not lowres else "cluster_sort"] > 0, (
            launches)
        t = tables[0]
        assert len(t) > 0.9 * B, len(t)
        assert np.isfinite(t.columns["hyperscore"]).all()
        assert np.isfinite(t.columns["delta_mass"]).all()
        rec.update(spectra_per_s=B / wall_s, wall_s=wall_s,
                   banded_dispatches=len(calls), W=lp.get("W"),
                   nbcov=[c[3] for c in calls], F=[c[2] for c in calls],
                   totmax=totmax, overflow_reruns=reruns,
                   launches=launches, rescore_launches=r_launches,
                   prep_launches=p_launches, peak_launches=peak_launches,
                   peak_device_gib=peak_gib)

        # the candidate-major stage 1 on the same batch
        with EnvSet("SAGE_TPU_NARROW_BANDED", "0"):
            ref = tsearch.Scorer(db, params)
            list(ref.score_stream([warm]))
            ref._psm_counter = 1
            pallas_stage1.launches = 0
            sync()
            t0 = time.perf_counter()
            ref_t = list(ref.score_stream([batch]))[0]
            sync()
            ref_s = time.perf_counter() - t0
            ref_launches = pallas_stage1.launches
        assert "banded" not in ref.last_plan and ref_launches > 0
        assert_tables_equal(t, ref_t, f"{name} banded vs candidate-major")
        log(f"# {name}: candidate-major stage 1 (Wb {ref.last_plan.get('W')})"
            f" {B} spectra in {ref_s:.3f} s = {B / ref_s:.1f} spectra/s, "
            f"stage1_counts launches {ref_launches}; all "
            f"{len(t.columns)} FeatureTable columns equal the banded run's "
            f"({len(t)} PSMs)")
        rec.update(reference_spectra_per_s=B / ref_s,
                   reference_stage1_launches=ref_launches)

        # the auto gate (no environment variable) on the same batch: the
        # path it takes at this W is the gate's, the columns the same
        with EnvSet("SAGE_TPU_NARROW_BANDED", None):
            auto = tsearch.Scorer(db, params)
            want = auto._narrow_banded_maybe(lp["W"]) is not None
            auto._psm_counter = 1
            auto_t = auto.score_table(batch)
        took = bool(auto.last_plan.get("banded"))
        assert took == want, (took, want)
        assert_tables_equal(auto_t, t, f"{name} auto gate")
        rec["auto_path"] = "banded" if took else "candidate_major"
        log(f"# {name}: with no environment variable the gate took the "
            f"{rec['auto_path']} stage 1 at W {lp['W']}; columns equal")

        if cpu_spectra:
            sub = batch[:cpu_spectra]
            n0 = len(calls)
            with Recording(tbanded.NarrowBanded, "dispatch",
                           lambda out, nb_, *a, **k: calls.append(
                               nb_.device.type)):
                t_gpu = tsearch.Scorer(db, params).score_table(sub)
                t_cpu = tsearch.Scorer(db, params,
                                       device="cpu").score_table(sub)
            assert {scorer.device.type, "cpu"} <= set(calls[n0:]), calls[n0:]
            assert_tables_equal(t_gpu, t_cpu, f"{name} card vs CPU")
            log(f"# {name} card vs CPU: {len(t_cpu)} PSMs of {len(sub)} "
                f"spectra (banded), all {len(t_cpu.columns)} "
                f"FeatureTable columns equal")

        # the batch once more, its sort inputs recorded
        sorts = []
        scorer._psm_counter = 1
        if peak_in is not None:
            peak_in.clear()
        with Recording(topen, "bitonic_sort_rows",
                       lambda out, x, *a, **k: sorts.append(x.clone())), \
                capture_peak(topen, tbanded,
                             peak_in if peak_in is not None else {}):
            again = scorer.score_table(batch)
        if peak_in is not None:
            peak_in["searcher"] = nb
        assert_tables_equal(again, t, f"{name} recorded run")
        # one launch for each sort of the measured run (unless a rerun
        # added sorts): the cluster kernel for rows past the one-pass
        # limit, the row-sort kernel for the others
        n_long = sum(1 for x in sorts if x.shape[1] > pallas_sort._BLOCK_MAX)
        want = {"row_sort": len(sorts) - n_long, "cluster_sort": n_long}
        assert launches == want if not measured_reruns else all(
            launches[k] >= n for k, n in want.items()), (launches, want)
        assert not lowres or n_long == len(sorts) > 0
        breakdown = profile_batch(
            torch, scorer, batch, banded_profile_ranges(tbanded, topen,
                                                        tsearch),
            PEAK_KERNEL_KEYS)
        rec["batch_breakdown"] = breakdown
        rec["sort_rows"] = [list(x.shape) for x in sorts]

        # the kernels against their plain versions at these inputs
        for i, x in enumerate(sorts):
            got = pallas_sort.bitonic_sort_rows(x)
            assert torch.equal(got, torch.sort(x, dim=1).values), i
            assert torch.equal(got, _plain_sort(pallas_sort, x)), i
        sync()
        log(f"# {name} kernels vs plain: {len(sorts)} sort inputs "
            f"{rec['sort_rows']} bit-equal (kernel, plain version and "
            f"torch.sort)")
        if lowres:
            rec["cluster"] = time_cluster(
                torch, pallas_sort, sorts, f"{name} {B}-spectrum batch",
                parent="phase16")
            rec["cluster"]["launches"] = len(sorts)
        else:
            rec["sort"] = time_sorts(torch, pallas_sort, sorts,
                                     f"{name} {B}-spectrum batch")
        del sorts
    return rec


def crossover_phase(torch, mods, db, spectra, times):
    """Phase 19: where the banded stage 1 beats the candidate-major one on
    this card. Phase 15's 8192-spectrum batch, after a warm-up batch and
    one untimed run of the batch itself (so F is learned and no batch is
    redone), at precursor windows of +-3 and +-6 Da (the batch's widest
    window at W = 8192 and 16384 candidates, kept in the narrow regime by
    raising SAGE_TPU_OPEN_THRESHOLD), each
    with +-10 ppm and +-0.5 Da fragments. Both paths are forced
    (SAGE_TPU_NARROW_BANDED=1 and =0) and timed in the order banded,
    candidate-major, candidate-major, banded; every column must be equal.
    One batch of each is then profiled: the stage 1's device ms (banded:
    the range search, entry gather, sort and run-count kernels and the
    torch ops around them; candidate-major: stage-1
    kernel and its top-K layout) beside the batch's device busy time.
    Records per cell whether banded won both repetitions and which path
    the auto gate takes there."""
    tsearch, tbanded, topen, pallas_stage1 = (
        mods["search"], mods["banded"], mods["open"], mods["stage1"])
    sync = torch.cuda.synchronize
    B = BANDED_BATCH
    warm, batch = spectra[:B], spectra[B:2 * B]
    flags = {"banded": "1", "candidate_major": "0"}
    ranged = [(tbanded, "_banded_ranges"), (tbanded, "_open_count_core"),
              (tsearch, "_topk_layout"), (tsearch, "rescore_indexed")]
    kernel_keys = {"stage1_counts": "stage1_counts", **PEAK_KERNEL_KEYS}
    cells = []
    with Phase("19_banded_crossover", times), \
            EnvSet("SAGE_TPU_OPEN_THRESHOLD", str(1 << 20)):
        for da in CROSSOVER_PREC:
            for frag in CROSSOVER_FRAG:
                params = tsearch.SearchParams(
                    precursor_tol=tsearch.Tolerance("da", -da, da),
                    fragment_tol=tsearch.Tolerance(*frag))
                cell = {"precursor_da": da, "fragment_tol": list(frag)}
                scorers, walls, tabs, peaks = {}, {}, {}, {}
                for path, flag in flags.items():
                    with EnvSet("SAGE_TPU_NARROW_BANDED", flag):
                        sc = tsearch.Scorer(db, params)
                        list(sc.score_stream([warm]))
                        list(sc.score_stream([batch]))
                    scorers[path], walls[path] = sc, []
                for path in ("banded", "candidate_major",
                             "candidate_major", "banded"):
                    sc = scorers[path]
                    sc._psm_counter = 1
                    reruns0 = sc.fused_reruns
                    torch.cuda.reset_peak_memory_stats()
                    with EnvSet("SAGE_TPU_NARROW_BANDED", flags[path]):
                        sync()
                        t0 = time.perf_counter()
                        tabs[path] = list(sc.score_stream([batch]))[0]
                        sync()
                    walls[path].append(time.perf_counter() - t0)
                    peaks[path] = torch.cuda.max_memory_allocated() / 2**30
                    assert sc.fused_reruns == reruns0, path
                    assert (bool(sc.last_plan.get("banded"))
                            == (path == "banded")), (path, sc.last_plan)
                assert_tables_equal(tabs["banded"], tabs["candidate_major"],
                                    f"crossover +-{da} Da {frag}")
                lp = scorers["banded"].last_plan
                with EnvSet("SAGE_TPU_NARROW_BANDED", None):
                    auto = scorers["banded"]._narrow_banded_maybe(lp["W"])
                cell.update(W=lp["W"], nbcov=lp["nbcov"], F=lp["F"],
                            psms=len(tabs["banded"]),
                            auto_path=("banded" if auto is not None
                                       else "candidate_major"),
                            banded_won=min(walls["candidate_major"])
                            > max(walls["banded"]))
                for path, sc in scorers.items():
                    with EnvSet("SAGE_TPU_NARROW_BANDED", flags[path]):
                        ph = profile_batch(torch, sc, batch, ranged,
                                           kernel_keys, top=0)
                    if path == "banded":
                        # torch ops inside the two ranges, and the kernels
                        # (launched through ctypes, so outside any range)
                        s1 = (ph.get("_banded_ranges_device_ms", 0)
                              + ph.get("_open_count_core_device_ms", 0)
                              + sum(ph.get(f"{k}_kernel_device_ms", 0)
                                    for k in ("row_sort", "cluster_sort")
                                    + PEAK_KERNELS))
                    else:
                        s1 = (ph.get("stage1_counts_kernel_device_ms", 0)
                              + ph.get("_topk_layout_device_ms", 0))
                    cell[path] = {
                        "spectra_per_s": [B / w for w in walls[path]],
                        "wall_s": walls[path], "peak_device_gib": peaks[path],
                        "stage1_device_ms": s1 if ph.get("device_busy_ms")
                        else None,
                        "profile": ph}
                bd, cm = cell["banded"], cell["candidate_major"]
                log(f"# 19 crossover +-{da} Da, fragment {frag}: W {cell['W']}"
                    f", nbcov {cell['nbcov']}, F {cell['F']}, {cell['psms']} "
                    f"PSMs, columns equal; spectra/s banded "
                    f"{[round(x, 1) for x in bd['spectra_per_s']]} vs "
                    f"candidate-major "
                    f"{[round(x, 1) for x in cm['spectra_per_s']]}; stage-1 "
                    f"device ms banded {bd['stage1_device_ms']} vs "
                    f"candidate-major {cm['stage1_device_ms']}; busy ms "
                    f"{bd['profile'].get('device_busy_ms')} vs "
                    f"{cm['profile'].get('device_busy_ms')}; peak GiB "
                    f"{peaks['banded']:.2f} vs {peaks['candidate_major']:.2f}; "
                    f"banded faster in both repetitions: {cell['banded_won']}"
                    f"; the auto gate takes {cell['auto_path']}")
                cells.append(cell)
                del scorers, tabs
    return {"cells": cells}


RESCORE_OUTS = ("mb", "my", "summed_b", "summed_y", "ppm_sum", "longest_b",
                "longest_y")


def rescore_cases_module():
    """tests/_rescore_cases.py, loaded by path (it imports numpy only)."""
    import importlib.util

    path = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests",
                        "_rescore_cases.py")
    spec = importlib.util.spec_from_file_location("_rescore_cases", path)
    cases = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cases)
    return cases


def rescore_edge_inputs():
    """Phase 25's crafted inputs, by name: the edge cases whose rows
    ascend in mass, as the kernel requires (peaks on their IEEE bounds
    among them), and the card's random shapes (one item a row,
    more items a row than a block has warps, the widest ladder) of
    tests/_rescore_cases.py, as the card's tests make them."""
    cases = rescore_cases_module()
    out = cases.kernel_cases()
    for name, shape in cases.CARD_SHAPES.items():
        out[name] = cases.shape_case(shape, seed_extra=shape[-1])
    return out


def rescore_check(torch, trescore, args, kw, what):
    """The kernel against its plain version on the indexed form's
    ``args`` (lad, pep, spec, pkm, pki, maxz, live): all seven outputs
    bit-equal."""
    got = trescore.rescore_indexed(*args, **kw)
    want = trescore.rescore_indexed_plain(*args, **kw)
    torch.cuda.synchronize()
    for name, g, w in zip(RESCORE_OUTS, got, want):
        assert g.dtype == w.dtype and g.shape == w.shape, (what, name)
        if g.dtype == torch.float32:
            g, w = g.view(torch.int32), w.view(torch.int32)
        assert torch.equal(g, w), (what, name)
    return got


def rescore_work(torch, trescore, args, kw):
    """Bytes and compares of one rescore call, three ways. The linear
    scan's bound: every item x slot x live charge x peak of its row, two
    compares each, and the bytes of the gathered form (the items'
    ladders, a peak row a row of items, maxz and the outputs). The
    real-work bound: the same over live items, finite slots, live charges
    and live peaks (intensity >= 0). This design's bound: the bytes of the
    live items' ladder rows; of each peak row they read, its peaks short
    of the +inf pads plus the one pad that ends a walk; of pep and maxz at
    the live items and of spec and live; and of the outputs, each moved
    once, against the compares its search
    needs for this run's data: for each live (finite slot, live charge)
    pair, ceil(log2(Pk + 1)) for the range's start a, and the walk's
    b - a peaks plus the one that ends it (when b < Pk);
    torch.searchsorted on the card gives a and b, and a NaN bound gives
    the empty range."""
    lad, pep, spec, pkm, pki, maxz, live = args
    kind, tlo, thi = kw["frag_tol"]
    Z = kw["Z"]
    n, k = pep.shape
    P, S, L = lad.shape
    B, Pk = pkm.shape
    zlive = (maxz.long() - 1).clamp(0, Z)
    nl = (torch.full((n,), k, device=pep.device) if live is None
          else live.long().clamp(0, k))
    is_live = torch.arange(k, device=pep.device)[None, :] < nl[:, None]
    nbytes10 = float(n * k * S * L * 4 + 2 * n * Pk * 4 + n * k * 4
                     + 7 * n * k * 4)
    ops10 = float(zlive.sum()) * S * L * Pk * 2
    rows = spec.long().clamp(0, B - 1)
    r_idx, j_idx = is_live.nonzero(as_tuple=True)
    f = lad[pep[r_idx, j_idx].long().clamp(0, P - 1)]  # [N, S, L]
    zl = zlive[r_idx, j_idx]
    live_pk = (pki >= 0).sum(1)[rows[r_idx]]
    finite = torch.isfinite(f).sum((1, 2))
    real = float((finite * zl * live_pk).sum()) * 2
    read = torch.unique(rows[nl > 0])
    row_pk = ((pkm[read] < np.inf).sum(1) + 1).clamp(max=Pk)
    nbytes = float(r_idx.numel() * S * L * 4 + int(row_pk.sum()) * 8
                   + (2 * r_idx.numel() + 2 * n) * 4 + 7 * n * k * 4)
    search = 0.0
    pairs = 0
    log2 = math.log2
    pm_all = pkm[rows[r_idx]]
    fl = f.reshape(f.shape[0], S * L)
    step = max(1, (1 << 24) // max(S * L + Pk, 1))
    for zi in range(Z):
        for a0 in range(0, fl.shape[0], step):
            sl = slice(a0, a0 + step)
            mz = trescore._fdiv(fl[sl], zi + 1)
            lo, hi = trescore.tol_bounds_static(kind, tlo, thi, mz)
            pm = pm_all[sl].contiguous()
            ok = torch.isfinite(fl[sl]) & (zi < zl[sl])[:, None]
            lo_s = torch.where(torch.isnan(lo), np.inf, lo).contiguous()
            hi_s = torch.where(torch.isnan(hi), -np.inf, hi).contiguous()
            ai = torch.searchsorted(pm, lo_s, side="left")
            bi = torch.maximum(torch.searchsorted(pm, hi_s, side="right"), ai)
            walk = bi - ai + (bi < Pk).long()
            search += float((ok * (math.ceil(log2(Pk + 1)) + walk)).sum())
            pairs += int(ok.sum())
    return dict(bytes10=nbytes10, ops10=ops10, real10=real, bytes=nbytes,
                search_compares=search, live_pairs=pairs,
                live_items=int(r_idx.numel()),
                dead_items=int(n * k - r_idx.numel()))


def time_rescore(torch, trescore, args, kw, path, reps=10):
    """Kernel, plain version and kernel again with CUDA events at one
    captured input, beside the three bounds; one call of each timed on
    the host's clock without a synchronise. Returns the row."""
    sync = torch.cuda.synchronize
    w = rescore_work(torch, trescore, args, kw)
    b10, b10_by = bound_ms(w["bytes10"], w["ops10"], F32_COMPARES_PER_S)
    r10, r10_by = bound_ms(w["bytes10"], w["real10"], F32_COMPARES_PER_S)
    nb, nb_by = bound_ms(w["bytes"], w["search_compares"],
                         F32_COMPARES_PER_S)

    def kern():
        return trescore.rescore_indexed(*args, **kw)

    def plain():
        return trescore.rescore_indexed_plain(*args, **kw)

    km1 = exec_ms(kern, reps)
    p_ms = exec_ms(plain, 2)
    km2 = exec_ms(kern, reps)
    host = {}
    for what, fn in (("plain", plain), ("kernel", kern)):
        sync()
        t0 = time.perf_counter()
        fn()
        host[what] = (time.perf_counter() - t0) * 1e3
        sync()
    k_ms = (km1 + km2) / 2
    n, k = args[1].shape
    P, S, L = args[0].shape
    Pk, Z = args[3].shape[1], kw["Z"]
    out = kern()
    matched = int((out[0].long() + out[1].long()).sum())
    row = dict(
        shape=[n, k, S, L], Pk=Pk, Z=Z, ms=k_ms, ms_runs=[km1, km2],
        plain_ms=p_ms, bound_ms=nb, bound_by=nb_by, bound_share=nb / k_ms,
        bytes=w["bytes"], search_compares=w["search_compares"],
        scan_bound_ms=b10, scan_bound_by=b10_by, scan_bound_share=b10 / k_ms,
        scan_compares=w["ops10"], scan_bytes=w["bytes10"],
        real_bound_ms=r10, real_bound_by=r10_by, real_bound_share=r10 / k_ms,
        real_compares=w["real10"], live_items=w["live_items"],
        dead_items=w["dead_items"], live_pairs=w["live_pairs"],
        matched_pairs=matched, plain_host_ms=host["plain"],
        kernel_host_ms=host["kernel"])
    log(f"# rescore {path} [n {n}, k {k}, S {S}, L {L}] Pk {Pk} Z {Z}: "
        f"bit-equal; kernel {km1:.4f} / {km2:.4f} ms, plain {p_ms:.2f} ms; "
        f"this design's bound {nb:.4f} ms ({nb_by}; {w['bytes'] / 1e6:.2f} "
        f"MB at {HBM_BYTES_PER_S / 1e12:.2f} TB/s, "
        f"{w['search_compares'] / 1e9:.4f} G search compares at "
        f"{F32_COMPARES_PER_S / 1e12:.1f} T/s), share {nb / k_ms:.3f}; "
        f"the linear scan's bound {b10:.4f} ms ({b10_by}; "
        f"{w['ops10'] / 1e9:.3f} G compares, {w['bytes10'] / 1e6:.1f} MB), "
        f"share {b10 / k_ms:.3f}; "
        f"the real-work bound {r10:.4f} ms ({r10_by}; "
        f"{w['real10'] / 1e9:.3f} G compares; {w['dead_items']} of {n * k} "
        f"items dead), share {r10 / k_ms:.3f}; {w['live_pairs']} live "
        f"(finite slot, live charge) pairs, {matched} matched (the serial "
        f"tail's steps); one call's host ms without "
        f"a synchronise: plain {host['plain']:.2f}, kernel "
        f"{host['kernel']:.3f}")
    return row


def rescore_phase(torch, trescore, captured, dev, times):
    """Phase 25: the rescore kernel against its plain version on the card
    at the crafted inputs (through the thin ``rescore_candidate`` form)
    and at the inputs ``captured`` on the main paths (path -> (args,
    keywords), the indexed form), all seven outputs bit-equal; at each
    captured input :func:`time_rescore`. Returns the rows by path."""
    rows = {}
    with Phase("25_rescore_kernel_vs_plain", times):
        edge = rescore_edge_inputs()
        for name, c in edge.items():
            f, pkm, pki, maxz = (torch.from_numpy(c[k]).to(dev)
                                 for k in ("f", "pkm", "pki", "maxz"))
            kw = dict(series=c["series"], frag_tol=c["frag_tol"], Z=c["Z"])
            n0 = trescore.launches
            got = trescore.rescore_candidate(f, pkm, pki, maxz, **kw)
            want = trescore.rescore_candidate_plain(f, pkm, pki, maxz, **kw)
            torch.cuda.synchronize()
            for out, g, w in zip(RESCORE_OUTS, got, want):
                if g.dtype == torch.float32:
                    g, w = g.view(torch.int32), w.view(torch.int32)
                assert torch.equal(g, w), (name, out)
            assert trescore.launches - n0 == (c["maxz"].size > 0), name
        log(f"# rescore kernel vs plain: {len(edge)} crafted inputs "
            f"{sorted(edge)} bit-equal (all seven outputs)")
        for path, (args, kw) in captured.items():
            rescore_check(torch, trescore, args, kw, path)
            rows[path] = time_rescore(torch, trescore, args, kw, path)
    return rows


def peak_cases_module():
    """tests/_peak_cases.py, loaded by path (it imports numpy, torch and
    tests/_rescore_cases.py)."""
    import importlib.util

    sys.modules.setdefault("_rescore_cases", rescore_cases_module())
    path = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests",
                        "_peak_cases.py")
    spec = importlib.util.spec_from_file_location("_peak_cases", path)
    cases = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cases)
    return cases


def _equal_outputs(torch, got, want, what):
    """Every tensor of ``got`` equal to ``want``'s (None where it is)."""
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        assert (g is None) == (w is None), what
        assert g is None or (g.dtype == w.dtype and torch.equal(g, w)), what


def peak_edge_checks(torch, topen, tbanded, dev):
    """The three kernels against their plain versions at crafted edges,
    tests/_peak_cases.py's generators as the card tests use them: the
    range search's three forms at three tolerance kinds and Z 1 and 3
    (fragments on the IEEE bounds, NaN, -inf, 0, +inf pads, invalid
    slots, an empty band); the gather's two layouts and two key forms at
    Z 1 and 3, nbcov 1 and 3, rows that fit and rows past F, and at
    12,000 peaks with Z 3 (its prefix in several tiles), its live counts
    among its outputs; the count's two key forms at Z 1 and 3, nbcov 1
    and 4, K 50 and 80, given the rows' live counts, runs longer than its
    warp form's 32-position steps, and rows of 12,000
    runs that fill and compact its top-K buffer (K 50 and 64 in its warp
    form, 1024 in its block form). Returns the number of inputs
    checked."""
    import itertools

    pc = peak_cases_module()
    n = 0

    def on(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    for tol in (("ppm", -10.0, 10.0), ("pct", -0.001, 0.002),
                ("da", -0.02, 0.02)):
        for Zb in (1, 3):
            frag_mz, off, cs = pc.range_masses(tol, seed=Zb)
            nb = off.size - 1
            masses = pc.range_peaks(cs, 7, 16, seed=Zb)
            peaks = on(np.stack([masses, np.ones_like(masses)]))
            tabs = pc.open_range_tables(topen, frag_mz, off, dev)
            rng = np.random.default_rng(Zb)
            kw = dict(Zb=Zb, tol=tol)
            a = (tabs, peaks, on(rng.integers(0, nb, (7, 3))),
                 on(rng.random((7, 3)) < 0.8))
            _equal_outputs(torch, topen._device_ranges(*a, **kw),
                           topen._device_ranges_plain(*a, **kw), tol)
            a = (tabs, peaks, on(rng.integers(0, 7, 11)),
                 on(rng.integers(0, nb, 11)), on(rng.random(11) < 0.8))
            _equal_outputs(torch, topen._device_ranges_flat(*a, **kw),
                           topen._device_ranges_flat_plain(*a, **kw), tol)
            bands = np.clip(rng.integers(0, nb, 7)[:, None] + np.arange(3),
                            0, nb - 1)
            valid = rng.random((7, 3)) < 0.8
            bb = np.stack([off[bands], np.where(valid, off[bands + 1],
                                                off[bands])], -1)
            a = (on(frag_mz), peaks[0], on(bb.astype(np.int32)))
            kw["nstep"] = int(np.ceil(np.log2(np.diff(off).max()))) + 2
            _equal_outputs(torch, tbanded._banded_ranges(*a, **kw),
                           tbanded._banded_ranges_plain(*a, **kw), tol)
            n += 3
    for chunked, Z, nbcov, packed, overflow in itertools.product(
            (False, True), (1, 3), (1, 3), (True, False), (False, True)):
        pep, st, ln = pc.entries_case(
            Z * 10 + nbcov, B=5, nbcov=nbcov, Z=Z, Pk=8, chunked=chunked,
            F=384, Wc=8, overflow=overflow)
        a = (on(pep.reshape(-1, 64)), on(st), on(ln))
        kw = dict(F=384, Wc=8, Pk=8, Z=Z, nbcov=nbcov, chunked=chunked,
                  packed=packed)
        _equal_outputs(torch, topen.open_entries(*a, **kw),
                       topen.open_entries_plain(*a, **kw), kw)
        n += 1
    rng = np.random.default_rng(12000)
    pep = rng.integers(0, 50000, 1 << 16).astype(np.int32)
    pep[-70:] = -1
    st = rng.integers(0, pep.size - 80, (3, 3 * 2 * 12000)).astype(np.int32)
    ln = ((rng.random(st.shape) < 0.02) * rng.integers(1, 4, st.shape)
          ).astype(np.int32)
    ln[0, :36000] = 1  # a row past F
    for chunked, packed in itertools.product((False, True), (True, False)):
        a = (on(pep.reshape(-1, 64)), on(st), on(ln))
        kw = dict(F=4096, Wc=1024, Pk=12000, Z=3, nbcov=2, chunked=chunked,
                  packed=packed)
        _equal_outputs(torch, topen.open_entries(*a, **kw),
                       topen.open_entries_plain(*a, **kw), kw)
        n += 1
    cases = [dict(case=pc.count_case(Z + 7 * nbcov + K, B=6, nbcov=nbcov,
                                     F=512, W=640, Z=Z, packed=packed, R=40,
                                     max_run=3),
                  F=512, K=K, nbcov=nbcov, Z=Z, packed=packed)
             for Z, nbcov, packed, K in itertools.product(
                 (1, 3), (1, 4), (True, False), (50, 80))]
    # runs longer than the warp form's 32-position steps
    cases += [dict(case=pc.count_case(Z + 7 * nbcov, B=6, nbcov=nbcov,
                                      F=512, W=640, Z=Z, packed=True, R=40,
                                      max_run=40),
                   F=512, K=50, nbcov=nbcov, Z=Z, packed=True)
              for Z, nbcov in itertools.product((1, 3), (1, 4))]
    for K in (50, 64, 1024):
        case = pc.count_case(
            5, B=3, nbcov=1, F=16384, W=16384, Z=1, packed=True, R=6,
            band_w=20000, max_run=1)
        rows, zs, live, spec, i0, i1, maxz = case
        i0[:], i1[:], spec[:] = 0, 20000, [0, 2] * 3
        cases.append(dict(case=case, F=16384, K=K, nbcov=1, Z=1,
                          packed=True))
    for c in cases:
        rows, zs, *q = c.pop("case")
        a = (on(rows), None if zs is None else on(zs), *(on(x) for x in q))
        _equal_outputs(torch, topen.open_count(*a, **c),
                       topen.open_count_plain(*a, **c), c)
        n += 1
    return n


def _composite(torch, mz, band_off, dev):
    """The (band, m/z)-sorted masses as one ascending f64 sequence,
    band * 2^17 + m/z (every m/z is below 2^17): torch.searchsorted over
    it finds a bound's rank in its band's segment."""
    band = np.repeat(np.arange(band_off.size - 1), np.diff(band_off))
    comp = band.astype(np.float64) * 131072.0 + mz[: band.size]
    return torch.from_numpy(comp).to(dev)


def _bounds_of(torch, topen, masses, spec, Zb, tol):
    """f32 bounds [Zb, NS, Pk] of the rows ``spec`` of ``masses``."""
    lo, hi = zip(*(topen._peak_bounds(masses[spec], zi, tol)
                   for zi in range(Zb)))
    return torch.stack(lo), torch.stack(hi)


def ranges_work(torch, topen, form, args, kw, searcher):
    """Bytes, compares and a library yardstick for one range search.
    Bytes: the peak masses, the slot or segment tables and the two i32
    outputs, each moved once. Compares: two binary searches for each
    element that searches (a valid slot with finite bounds that meet the
    band's span; the banded form searches every element), ceil(log2(n +
    1)) steps over its band's (or segment's) n masses, for this run's
    data. The yardstick: torch.searchsorted of every element's two
    bounds, keyed band * 2^17 + bound, over the composite sequence
    (:func:`_composite`), left for the low bound and right for the high
    one: two calls."""
    Zb, tol = kw["Zb"], kw["tol"]
    dev = args[1].device
    if form == "banded":
        frag_mz, masses, bb = args
        B, Pk = masses.shape
        nbcov = bb.shape[1]
        seg = bb.reshape(-1, 2).long()
        n_el = B * Zb * nbcov * Pk
        steps = torch.ceil(torch.log2((seg[:, 1] - seg[:, 0]).double() + 1))
        ops = 2.0 * float(steps.sum()) * Zb * Pk
        nbytes = B * Pk * 4 + bb.numel() * 4 + 2 * n_el * 4
        off = torch.from_numpy(searcher.band_off).to(dev)
        band = torch.searchsorted(off, seg[:, 0].contiguous(), right=True) - 1
        spec = torch.arange(B, device=dev).repeat_interleave(nbcov)
        comp = _composite(torch, searcher.frag_mz_dev.cpu().numpy(),
                          searcher.band_off, dev)
    else:
        tabs, peaks = args[0], args[1]
        masses = peaks[0]
        B, Pk = masses.shape
        _mz, _d, _d2, _ro, blen, _bo, bfirst, blast = tabs
        if form == "grid":
            band, valid = args[2].reshape(-1), args[3].reshape(-1)
            spec = torch.arange(B, device=dev).repeat_interleave(
                args[2].shape[1])
        else:
            spec, band, valid = args[2], args[3], args[4]
        lo, hi = _bounds_of(torch, topen, masses, spec.long(), Zb, tol)
        hit = (valid[None, :, None] & torch.isfinite(lo) & torch.isfinite(hi)
               & (hi >= bfirst[band][None, :, None])
               & (lo <= blast[band][None, :, None]))
        steps = torch.ceil(torch.log2(blen[band].double() + 1))
        ops = 2.0 * float((hit * steps[None, :, None]).sum())
        n_el = band.numel() * Zb * Pk
        nbytes = B * Pk * 4 + band.numel() * 17 + 2 * n_el * 4
        comp = _composite(torch, searcher.frag_mz, searcher.band_off, dev)
    lo, hi = _bounds_of(torch, topen, masses, spec.long(), Zb, tol)
    key = band.double()[None, :, None] * 131072.0
    v_lo = (key + torch.where(torch.isfinite(lo), lo, 0).double()).reshape(-1)
    v_hi = (key + torch.where(torch.isfinite(hi), hi, 0).double()).reshape(-1)

    def library():
        return (torch.searchsorted(comp, v_lo),
                torch.searchsorted(comp, v_hi, right=True))

    return float(nbytes), ops, library


def queued_device_ms(torch, fn, reps=10, spin_cycles=40_000_000):
    """Device ms of one call of ``fn``, its host launch cost excluded:
    after a warm call, a spin kernel holds the stream (about 20 ms) while
    the host queues ``reps`` calls behind it between two CUDA events, so
    the events time the calls' device work back to back. CUDA events
    around calls that are not held (``exec_ms``) time the host's launch
    cost instead when a call's device work is shorter than it. Raises if
    the host took longer to queue the calls than the spin lasted."""
    fn()
    torch.cuda.synchronize()
    s0, e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(3))
    s0.record()
    torch.cuda._sleep(spin_cycles)
    e0.record()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    host_ms = (time.perf_counter() - t0) * 1e3
    e1.record()
    e1.synchronize()
    spin_ms = s0.elapsed_time(e0)
    assert host_ms < spin_ms, (host_ms, spin_ms)
    return e0.elapsed_time(e1) / reps


def peak_phase(torch, topen, tbanded, captured, dev, times):
    """Phase 27: the peak-major kernels against their plain versions on
    the card, at crafted edges (:func:`peak_edge_checks`) and at the
    inputs ``captured`` on the main paths (path -> kernel -> (args,
    keywords), each path's ``searcher`` beside them): outputs equal (i32).
    At each captured input timed with CUDA events: the kernel's calls
    queued behind a spin kernel (:func:`queued_device_ms`), the plain
    version, the kernel again, and calls not held (the host's launch cost
    included), beside the card's bound for the same work and, for the
    range search, the library yardstick (:func:`ranges_work`), timed
    both ways. The
    gather's bytes: the windows' starts and lengths, the live entries'
    peptide ids and the rows (and tags) and live counts written, each
    once; the count's: the entries that count (every query row's matched
    total, summed), the query rows, the live counts and the [R, 2K+2]
    output, against two int32 operations an entry. The gather's and the
    count's times before their redesign (``PREVIOUS_PEAK_MS``) are
    printed beside in the log, and kept in no row. Returns the rows, kernel -> path -> row."""
    rows = {k: {} for k in PEAK_KERNELS}
    fns = {"ranges": ("peak_ranges", topen._device_ranges,
                      topen._device_ranges_plain, "grid"),
           "ranges_flat": ("peak_ranges", topen._device_ranges_flat,
                           topen._device_ranges_flat_plain, "slots"),
           "banded_ranges": ("peak_ranges", tbanded._banded_ranges,
                             tbanded._banded_ranges_plain, "banded"),
           "entries": ("open_entries", topen.open_entries,
                       topen.open_entries_plain, None),
           "count": ("open_count", topen.open_count, topen.open_count_plain,
                     None)}
    with Phase("27_peak_kernels_vs_plain", times):
        n_edge = peak_edge_checks(torch, topen, tbanded, dev)
        log(f"# peak-major kernels vs plain: {n_edge} crafted inputs equal "
            f"(range search, entry gather, run-count top-K)")
        for path, store in captured.items():
            searcher = store.get("searcher")
            for key, (name, fn, plain, form) in fns.items():
                if key not in store:
                    continue
                args, kw = store[key]
                out = fn(*args, **kw)
                _equal_outputs(torch, out, plain(*args, **kw),
                               f"{name} at {path}")
                library = None
                if name == "peak_ranges":
                    nbytes, ops, library = ranges_work(
                        torch, topen, form, args, kw, searcher)
                    bm, by = bound_ms(nbytes, ops, F32_COMPARES_PER_S)
                    what = f"{form} form, {out[0].numel()} elements"
                elif name == "open_entries":
                    keys, tags, live_n = out
                    bad = 2**31 - 1 if kw["packed"] else 1 << 30  # no entry
                    live = int((keys != bad).sum())
                    assert live == int(live_n.long().sum()), name
                    nbytes = (args[1].numel() * 8 + live * 4
                              + keys.numel() * 4 + live_n.numel() * 4
                              + (0 if tags is None else tags.numel() * 4))
                    ops = 0.0
                    bm, by = bound_ms(nbytes, ops, INT32_OPS_PER_S)
                    what = (f"rows {list(keys.shape)}, {live} live entries, "
                            f"chunked {kw['chunked']}, packed "
                            f"{kw['packed']}")
                else:
                    K = kw["K"]
                    entries = float(out[:, 2 * K].long().sum())
                    per = 8 if (kw["Z"] > 1 and not kw["packed"]) else 4
                    nbytes = (entries * per + out.shape[0] * 16
                              + args[2].numel() * 4 + out.numel() * 4)
                    ops = 2.0 * entries
                    bm, by = bound_ms(nbytes, ops, INT32_OPS_PER_S)
                    what = (f"{out.shape[0]} query rows, nbcov "
                            f"{kw['nbcov']}, rows {list(args[0].shape)} cut "
                            f"to F {kw['F']}, {int(entries)} entries count")
                def kern():
                    return fn(*args, **kw)

                km1 = queued_device_ms(torch, kern)
                pm = exec_ms(lambda: plain(*args, **kw), 2)
                km2 = queued_device_ms(torch, kern)
                call_ms = exec_ms(kern, 10)
                lm = queued_device_ms(torch, library) if library else None
                lib_call_ms = exec_ms(library, 10) if library else None
                k_ms = (km1 + km2) / 2
                prev = PREVIOUS_PEAK_MS.get(name, {}).get(path)
                before = ("not measured at this input" if prev is None
                          else f"{prev} ms")
                row = dict(ms=k_ms, ms_runs=[km1, km2], call_ms=call_ms,
                           plain_ms=pm, bound_ms=bm, bound_by=by,
                           bound_share=bm / k_ms, bytes=nbytes, ops=ops,
                           library_ms=lm, library_call_ms=lib_call_ms,
                           input=what)
                rows[name][path] = row
                log(f"# {name} at {path} ({what}): equal to the plain "
                    f"version; kernel {km1:.4f} / {km2:.4f} ms (calls "
                    f"queued behind a spin; before the redesign "
                    f"{before}), {call_ms:.4f} "
                    f"ms a call not "
                    f"held (the host's launch cost included), plain "
                    f"{pm:.3f} ms, library "
                    f"{'none' if lm is None else f'{lm:.4f} ms'} "
                    f"({'-' if lib_call_ms is None else f'{lib_call_ms:.4f}'}"
                    f" ms not held); bound {bm:.4f} ms ({by}; "
                    f"{nbytes / 1e6:.2f} MB, {ops / 1e9:.4f} G ops), share "
                    f"{bm / k_ms:.3f}")
    return rows


def large_peaks_phase(torch, mods, db, times, n_spec=LARGE_PEAK_SPECTRA):
    """Phase 26: spectra of LARGE_PEAKS peaks (a search with max_peaks
    12,000; bench.py's database), precursor charge 4 and fragment
    charges up to 3 (Z = 3), through the Scorer on the card, fused and
    two-dispatch, with both kernels' counters set to 0 just before each
    run and > 0 after; every FeatureTable column equal to the CPU port's
    fused run. The stage-1 kernel at the fused run's captured segments and
    the rescore kernel at its captured input, each against its plain
    version, bit-equal, and timed (kernel, plain, kernel)."""
    tsearch, pallas_stage1, trescore = (mods["search"], mods["stage1"],
                                        mods["rescore"])
    tprep = prep_mod()
    from sage_tpu_torch.spectrum.processor import (Precursor, RawSpectrum,
                                                   SpectrumProcessor)

    sync = torch.cuda.synchronize
    rec = {}
    with Phase("26_large_peaks", times):
        proc = SpectrumProcessor(LARGE_PEAKS, False)
        arrays = rescore_cases_module().large_peak_arrays(
            db, n_spec, LARGE_PEAKS + 1000, seed=41)
        spectra = [proc.process(RawSpectrum(
            ms_level=2, id=f"scan={i}", centroid=True,
            precursors=[Precursor(mz=a["prec_mz"], charge=a["charge"])],
            mz=a["mz"], intensity=a["intensity"]))
            for i, a in enumerate(arrays)]
        assert {len(s.masses) for s in spectra} == {LARGE_PEAKS}
        params = tsearch.SearchParams(
            precursor_tol=tsearch.Tolerance("ppm", -20.0, 20.0),
            fragment_tol=tsearch.Tolerance("ppm", -10.0, 10.0),
            max_fragment_charge=3)
        segs, store, tables, launches = [], {}, {}, {}
        real_s1 = tsearch.stage1_counts

        def recording(lad, peaks, ints, **kw):
            segs.append((lad, peaks, ints, kw))
            return real_s1(lad, peaks, ints, **kw)

        for fused in ("1", "0"):
            with EnvSet("SAGE_TPU_FUSED", fused):
                scorer = tsearch.Scorer(db, params)
                assert scorer.Z == 3, scorer.Z
                pallas_stage1.launches = 0
                trescore.launches = 0
                tprep.launches = 0
                tsearch.stage1_counts = recording
                try:
                    with capture_rescore(tsearch, store, fused):
                        t0 = time.perf_counter()
                        tables[fused] = scorer.score_table(spectra)
                        sync()
                        secs = time.perf_counter() - t0
                finally:
                    tsearch.stage1_counts = real_s1
                launches[fused] = {"stage1_counts": pallas_stage1.launches,
                                   "rescore": trescore.launches,
                                   "batch_prep": tprep.launches}
                assert all(v > 0 for v in launches[fused].values()), (
                    fused, launches[fused])
                log(f"# 26 Scorer at {LARGE_PEAKS} peaks, SAGE_TPU_FUSED="
                    f"{fused}: {len(tables[fused])} PSMs in {secs:.2f} s, "
                    f"launches {launches[fused]}")
                del scorer
        t0 = time.perf_counter()
        cpu = tsearch.Scorer(db, params, device="cpu").score_table(spectra)
        cpu_s = time.perf_counter() - t0
        assert len(cpu) > 0
        for fused in ("1", "0"):
            assert_tables_equal(tables[fused], cpu,
                                f"26 large peaks fused={fused}")
        log(f"# 26 columns equal, card (fused and two-dispatch) and CPU "
            f"({cpu_s:.1f} s), {len(cpu)} PSMs, matched peaks up to "
            f"{int(cpu.columns['matched_peaks'].max())}")
        # the stage-1 kernel at the fused run's segments
        s1 = []
        for lad, peaks, ints, kw in segs[:3]:
            got = pallas_stage1.stage1_counts(lad, peaks, ints, **kw)
            want = pallas_stage1.stage1_counts_plain(lad, peaks, ints, **kw)
            sync()
            assert torch.equal(got, want), kw
            R = ints.shape[1]
            S = lad.shape[1]
            nbytes, ops = segment_work(ints.cpu().numpy(), kw["W"],
                                       kw["Lc"], kw["Z"], S, peaks.shape[1],
                                       peaks.shape[0])
            b_ms, b_by = bound_ms(nbytes, ops, F32_COMPARES_PER_S)
            km1 = exec_ms(lambda: pallas_stage1.stage1_counts(
                lad, peaks, ints, **kw), 5)
            p_ms = exec_ms(lambda: pallas_stage1.stage1_counts_plain(
                lad, peaks, ints, **kw), 1)
            km2 = exec_ms(lambda: pallas_stage1.stage1_counts(
                lad, peaks, ints, **kw), 5)
            k_ms = (km1 + km2) / 2
            s1.append(dict(R=R, W=kw["W"], Lc=kw["Lc"], Z=kw["Z"],
                           Pk=peaks.shape[1], ms=k_ms, ms_runs=[km1, km2],
                           plain_ms=p_ms, bound_ms=b_ms, bound_by=b_by,
                           bound_share=b_ms / k_ms))
            log(f"# 26 stage1_counts [R {R}, W {kw['W']}, Lc {kw['Lc']}, Z "
                f"{kw['Z']}] Pk {peaks.shape[1]}: equal to plain; kernel "
                f"{km1:.3f} / {km2:.3f} ms, plain {p_ms:.1f} ms, bound "
                f"{b_ms:.4f} ms ({b_by}), share {b_ms / k_ms:.3f}")
        assert s1 and all(r["Z"] == 3 and r["Pk"] >= LARGE_PEAKS for r in s1)
        rows = {}
        for fused, (args, kw) in store.items():
            path = "fused" if fused == "1" else "two_dispatch"
            rescore_check(torch, trescore, args, kw, f"26 {path}")
            rows[path] = time_rescore(torch, trescore, args, kw,
                                      f"26 {path} at {LARGE_PEAKS} peaks",
                                      reps=5)
        rec.update(spectra=n_spec, peaks=LARGE_PEAKS, psms=len(cpu),
                   launches=launches, cpu_s=cpu_s, stage1=s1, rescore=rows)
    return rec


def chimeric_spectra(db, n, seed=17):
    """``n`` spectra of two peptides whose masses lie within 1.5 Da: 70%
    of each one's b/y ions, the first's at 1e5-1e6 and the second's at
    3e4-3e5, and 40 noise peaks at 1e3-1e4; the precursor (charge 2) is
    the first peptide's. Returns the spectra and the (first, second)
    peptide of each."""
    from sage_tpu_torch.chem.mass import PROTON
    from sage_tpu_torch.spectrum.processor import Precursor, ProcessedSpectrum

    rng = np.random.default_rng(seed)
    b, y = db.table.ladders()
    mono, lens = db.table.mono, db.table.lens
    order = np.argsort(mono, kind="stable")
    out, pairs = [], []
    while len(out) < n:
        k = int(rng.integers(0, order.size - 8))
        p, q = int(order[k]), int(order[k + int(rng.integers(1, 8))])
        if abs(float(mono[q]) - float(mono[p])) > 1.5 or min(
                lens[p], lens[q]) < 7:
            continue
        parts = []
        for pep, lo, hi in ((p, 1e5, 1e6), (q, 3e4, 3e5)):
            m = int(lens[pep]) - 1
            f = np.concatenate([b[pep, :m], y[pep, :m]])
            f = f[rng.random(f.shape[0]) < 0.7]
            parts.append((f, rng.uniform(lo, hi, f.shape[0])))
        parts.append((rng.uniform(150.0, float(mono[p]), 40),
                      rng.uniform(1e3, 1e4, 40)))
        masses = np.concatenate([m for m, _ in parts]).astype(np.float32)
        intens = np.concatenate([v for _, v in parts]).astype(np.float32)
        o = np.argsort(masses, kind="stable")
        out.append(ProcessedSpectrum(
            level=2, id=f"chimera={len(out)}", file_id=0,
            scan_start_time=len(out) * 0.01, ion_injection_time=1.0,
            precursors=[Precursor(mz=float(np.float32(mono[p]) / 2 + PROTON),
                                  charge=2)],
            masses=masses[o], intensities=intens[o],
            mobilities=np.zeros(0, np.float32),
            total_ion_current=np.float32(intens.sum()),
        ))
        pairs.append((p, q))
    return out, np.array(pairs)


def chimera_phase(torch, tsearch, pallas_stage1, db, times):
    """Phase 17: chimeric search on 2,048 two-peptide spectra (precursor
    +-1.5 Da, fragment +-10 ppm, report_psms 2) through ``score_stream``
    on the card; the stage-1 counter is set to 0 just before and must be
    > 0 after. Prints the share of spectra whose first PSM is the first
    peptide, whose second is the second and whose two PSMs are the two
    peptides (which must be over half), the rate and the host's
    peak-removal seconds; 32 spectra on the card and on the CPU must give
    equal FeatureTable columns."""
    params = tsearch.SearchParams(
        precursor_tol=tsearch.Tolerance(*BANDED_PREC),
        fragment_tol=tsearch.Tolerance("ppm", -10.0, 10.0),
        chimera=True, report_psms=2,
    )
    with Phase("17_chimera", times):
        spectra, pairs = chimeric_spectra(db, CHIMERA_SPECTRA)
        scorer = tsearch.Scorer(db, params)
        removal = []
        real_rm = scorer._remove_matched

        def timed_rm(*a):
            t = time.perf_counter()
            real_rm(*a)
            removal.append(time.perf_counter() - t)

        scorer._remove_matched = timed_rm
        trescore = rescore_mod()
        tprep = prep_mod()
        pallas_stage1.launches = 0
        trescore.launches = 0
        tprep.launches = 0
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        t = list(scorer.score_stream([spectra]))[0]
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0
        launches = pallas_stage1.launches
        r_launches = trescore.launches
        p_launches = tprep.launches
        peak_gib = torch.cuda.max_memory_allocated() / 2**30
        assert launches > 0, "chimera: stage1_counts not launched"
        assert p_launches == 0, "chimera: batch_prep launched"
        assert r_launches > 0, "chimera: the rescore kernel not launched"
        c = t.columns
        si, rank, pep = c["spec_idx"], c["rank"], c["peptide_idx"]
        assert set(np.unique(rank)) <= {1, 2} and (rank == 2).any()
        n = len(spectra)

        def found(r, col):
            """Spectra whose rank-r PSM is their pair's peptide ``col``."""
            h = np.zeros(n, bool)
            m = rank == r
            h[si[m]] = pep[m] == pairs[si[m], col]
            return h

        h1, h2 = found(1, 0), found(2, 1)
        both = float(((h1 & h2) | (found(1, 1) & found(2, 0))).mean())
        first, second = float(h1.mean()), float(h2.mean())
        log(f"# chimera: {n} spectra in {wall_s:.3f} s = {n / wall_s:.1f} "
            f"spectra/s; {len(t)} PSMs; the first peptide at rank 1 in "
            f"{first:.3f}, the second peptide at rank 2 in {second:.3f}, "
            f"both peptides found in {both:.3f} of the spectra; host "
            f"_remove_matched {sum(removal):.2f} s over {len(removal)} PSMs; "
            f"stage1_counts launches {launches}, rescore {r_launches}; peak "
            f"device memory {peak_gib:.2f} GiB")
        assert both > 0.5, (first, second, both)
        sub = spectra[:32]
        t_gpu = tsearch.Scorer(db, params).score_table(sub)
        t_cpu = tsearch.Scorer(db, params, device="cpu").score_table(sub)
        assert_tables_equal(t_gpu, t_cpu, "chimera card vs CPU")
        log(f"# chimera card vs CPU: {len(t_cpu)} PSMs of {len(sub)} "
            f"spectra, all {len(t_cpu.columns)} FeatureTable columns equal")
    return dict(spectra=len(spectra), wall_s=wall_s,
                spectra_per_s=len(spectra) / wall_s, psms=len(t),
                first_share=first, second_share=second, both_share=both,
                remove_matched_s=sum(removal), launches=launches,
                rescore_launches=r_launches, prep_launches=p_launches,
                peak_device_gib=peak_gib)


def write_mzml_scans(path, scans):
    """MS1 and MS2 scans (dicts of level, rt, mz, int and, for MS2,
    prec_mz and charge) as an mzML file."""
    with open(path, "w") as f:
        f.write('<?xml version="1.0"?><mzML><run><spectrumList>')
        for i, s in enumerate(scans):
            prec = "" if s["level"] == 1 else (
                "<precursorList><precursor><selectedIonList><selectedIon>"
                f'<cvParam accession="MS:1000744" value="{float(s["prec_mz"])!r}"/>'
                f'<cvParam accession="MS:1000041" value="{s["charge"]}"/>'
                "</selectedIon></selectedIonList></precursor>"
                "</precursorList>")
            f.write(
                f'<spectrum id="scan={i + 1}">'
                f'<cvParam accession="MS:1000511" value="{s["level"]}"/>'
                '<cvParam accession="MS:1000127" value=""/>'
                '<cvParam accession="MS:1000285" '
                f'value="{float(s["int"].sum())}"/>'
                "<scanList><scan>"
                f'<cvParam accession="MS:1000016" value="{float(s["rt"])!r}" '
                'unitAccession="UO:0000031"/></scan></scanList>' + prec
                + "<binaryDataArrayList>"
                '<binaryDataArray><cvParam accession="MS:1000523" value=""/>'
                '<cvParam accession="MS:1000574" value=""/>'
                '<cvParam accession="MS:1000514" value=""/>'
                f"<binary>{_enc(s['mz'], np.float64)}</binary>"
                "</binaryDataArray>"
                '<binaryDataArray><cvParam accession="MS:1000521" value=""/>'
                '<cvParam accession="MS:1000574" value=""/>'
                '<cvParam accession="MS:1000515" value=""/>'
                f"<binary>{_enc(s['int'], np.float32)}</binary>"
                "</binaryDataArray></binaryDataArrayList></spectrum>"
            )
        f.write("</spectrumList></run></mzML>")


def lfq_files(db, tmp, tag, n_ms2, n_ms1, seed):
    """Two mzML files for label-free quant. MS2 scans come from n_ms2 / 2
    target peptides (two scans each, at their elution apex): 70% of their
    singly charged b/y ions and 20 noise peaks, precursor charge 2. MS1
    scans, one every 0.05 min, carry each eluting peptide's charge-2
    isotope envelope (three peaks) over a Gaussian elution profile
    (sigma 0.1 min) beside 10 noise peaks. The second file's retention
    times are shifted by 0.15 min."""
    from sage_tpu_torch.chem.mass import NEUTRON, PROTON

    b, y = db.table.ladders()
    rng = np.random.default_rng(seed)
    cand = np.flatnonzero(~db.table.decoy & (db.table.lens >= 8))
    peps = rng.choice(cand, n_ms2 // 2, replace=False)
    T = 0.05 * n_ms1
    apex = rng.uniform(0.5, T - 0.5, peps.size)
    amp = rng.uniform(1e5, 1e7, peps.size)
    env = np.array([1.0, 0.62, 0.24])
    mono = db.table.mono.astype(np.float64)
    paths = []
    for f, shift in enumerate((0.0, 0.15)):
        frng = np.random.default_rng(seed + 1 + f)
        scans = []
        for i in range(n_ms2):
            j = i % peps.size
            p = int(peps[j])
            k = int(db.table.lens[p]) - 1
            ions = np.concatenate([b[p, :k], y[p, :k]]).astype(np.float64)
            ions = ions[frng.random(ions.size) < 0.7] + PROTON
            mz = np.sort(np.concatenate([ions, frng.uniform(150.0, 1800.0,
                                                             20)]))
            scans.append({"level": 2,
                          "rt": apex[j] + shift + frng.normal(0, 0.02),
                          "prec_mz": mono[p] / 2 + PROTON, "charge": 2,
                          "mz": mz, "int": frng.uniform(1e3, 1e6, mz.size)})
        for k in range(n_ms1):
            rt = T * (k + 0.5) / n_ms1
            near = np.flatnonzero(np.abs(rt - apex - shift) < 0.4)
            mz = [frng.uniform(350.0, 1500.0, 10)]
            it = [frng.uniform(1e2, 1e3, 10)]
            for j in near:
                h = amp[j] * np.exp(-0.5 * ((rt - apex[j] - shift) / 0.1) ** 2)
                mz.append((mono[peps[j]] + NEUTRON * np.arange(3)) / 2
                          + PROTON)
                it.append(h * env * frng.uniform(0.97, 1.03, 3))
            mz, it = np.concatenate(mz), np.concatenate(it)
            o = np.argsort(mz)
            scans.append({"level": 1, "rt": rt, "mz": mz[o], "int": it[o]})
        scans.sort(key=lambda s: s["rt"])
        path = os.path.join(tmp, f"{tag}{f}.mzML")
        write_mzml_scans(path, scans)
        paths.append(path)
    return paths


def lfq_phase(torch, pallas_stage1, tmp, times):
    """Phase 18: label-free quant and the HTML report through the Runner.
    (a) ``python -m sage_tpu_torch`` on the card and
    ``Runner(..., device="cpu")`` on two files of :func:`lfq_files` (512
    MS2 and 128 MS1 scans each) against a 300-protein FASTA, with
    ``quant.lfq``, ``write_report`` and chimeric search on: results.sage.tsv,
    lfq.tsv and sage.report.html (each run's output directory replaced
    by a placeholder) must be byte-equal, and lfq.tsv must hold target
    MS1 peaks at 5% FDR. (b) The Runner in this process on the card, on a
    6,000-protein FASTA (a yeast-size proteome) and two files of 4,096
    MS2 and 1,024 MS1 scans: the whole run's, the quant's and the
    report's seconds."""
    from sage_tpu_torch.bench_baseline import synth_fasta
    from sage_tpu_torch.chem.fasta import Fasta
    from sage_tpu_torch.pipeline import report as treport
    from sage_tpu_torch.pipeline.input import build_search
    from sage_tpu_torch.pipeline.runner import Runner

    def setup(n_prot, tag, **extra):
        """The FASTA and the config; the mzML files (written later, from
        the database) go to ``tag``0.mzML and ``tag``1.mzML."""
        fasta = os.path.join(tmp, f"{tag}.fasta")
        with open(fasta, "w") as f:
            f.write(synth_fasta(n_prot, seed=5))
        paths = [os.path.join(tmp, f"{tag}{i}.mzML") for i in (0, 1)]
        return search_config(fasta, paths, quant={"lfq": True},
                             write_report=True, **extra)

    names = ("results.sage.tsv", "lfq.tsv", "sage.report.html")
    with Phase("18a_lfq_report_cli", times):
        n_prot, n_ms2, n_ms1 = LFQ_SMALL
        cfg = setup(n_prot, "lfq_small", chimera=True, report_psms=2)
        dbp = build_search(json.loads(json.dumps(cfg)),
                           output_directory=tmp).database
        with open(cfg["database"]["fasta"]) as f:
            db = dbp.build(Fasta.parse(f.read(), dbp.decoy_tag,
                                       dbp.generate_decoys))
        lfq_files(db, tmp, "lfq_small", n_ms2, n_ms1, seed=23)
        cfg_path = os.path.join(tmp, "lfq.json")
        with open(cfg_path, "w") as f:
            json.dump(cfg, f)
        root = os.path.dirname(os.path.abspath(__file__))
        env = dict(os.environ)
        env["PYTHONPATH"] = os.pathsep.join(
            [root] + [p for p in env.get("PYTHONPATH", "").split(os.pathsep)
                      if p])
        outs = {"card": os.path.join(tmp, "lfq_card"),
                "cpu": os.path.join(tmp, "lfq_cpu")}
        t0 = time.perf_counter()
        r = subprocess.run(
            [sys.executable, "-m", "sage_tpu_torch", cfg_path, "-o",
             outs["card"]],
            cwd=root, env=env, capture_output=True, text=True, timeout=600,
        )
        cli_s = time.perf_counter() - t0
        if r.returncode != 0:
            log(r.stdout[-4000:])
            log(r.stderr[-4000:])
        assert r.returncode == 0, f"the CLI exited {r.returncode}"
        t0 = time.perf_counter()
        Runner(build_search(json.loads(json.dumps(cfg)),
                            output_directory=outs["cpu"]), device="cpu").run()
        cpu_s = time.perf_counter() - t0
        files = {}
        for k, d in outs.items():
            files[k] = []
            for n in names:
                with open(os.path.join(d, n), "rb") as f:
                    files[k].append(f.read().replace(d.encode(), b"OUTDIR"))
        for n, a, b in zip(names, files["card"], files["cpu"]):
            assert a == b, f"{n}: card and CPU differ"
        rows = files["card"][1].decode().splitlines()
        qcol = rows[0].split("\t").index("q_value")
        small5 = sum(float(r.split("\t")[qcol]) <= 0.05 for r in rows[1:])
        log(f"# LFQ via the CLI on the card: exit 0 in {cli_s:.1f} s; "
            f"results.sage.tsv, lfq.tsv ({len(rows) - 1} target precursors, "
            f"{small5} at 5% FDR) and sage.report.html "
            f"({len(files['card'][2])} bytes) byte-equal to the CPU Runner's "
            f"(CPU run {cpu_s:.1f} s)")
        assert small5 > 0, "no target MS1 peak at 5% FDR"

    with Phase("18b_lfq_report_timing", times):
        n_prot, n_ms2, n_ms1 = LFQ_LARGE
        cfg = setup(n_prot, "lfq_large")
        report_s = []

        def timed_render(*a, real=treport.render_report, **k):
            t = time.perf_counter()
            out = real(*a, **k)
            report_s.append(time.perf_counter() - t)
            return out

        runner = Runner(build_search(cfg, output_directory=os.path.join(
            tmp, "lfq_large_out")))
        db = runner.database
        lfq_files(db, tmp, "lfq_large", n_ms2, n_ms1, seed=23)
        pallas_stage1.launches = 0
        treport.render_report, real = timed_render, treport.render_report
        try:
            t0 = time.perf_counter()
            result = runner.run()
            torch.cuda.synchronize()
            run_s = time.perf_counter() - t0
        finally:
            treport.render_report = real
        ph = result["phases"]
        areas = result["lfq"]
        peaks5 = sum(1 for (_k, dec), (pk, _a) in areas.items()
                     if not dec and pk.q_value <= 0.05)
        log(f"# LFQ at yeast size: {len(db)} peptides, 2 x ({n_ms2} MS2 + "
            f"{n_ms1} MS1) scans; run() {run_s:.2f} s, quant_s {ph['quant_s']:.3f} s,"
            f" report {sum(report_s):.3f} s, search_s {ph['search_s']:.3f} "
            f"s; {result['q_spectrum']} PSMs at 1% FDR, {len(areas)} "
            f"quantified precursors, {peaks5} target peaks at 5% FDR; "
            f"stage1_counts launches {pallas_stage1.launches}; phases {ph}")
        assert pallas_stage1.launches > 0 and report_s and peaks5 > 0
    return dict(cli_s=cli_s, cpu_runner_s=cpu_s, small_peaks_5pct=small5,
                run_s=run_s, quant_s=ph["quant_s"], report_s=sum(report_s),
                phases=ph, peptides=len(db), large_peaks_5pct=peaks5)


def main():
    import torch

    # the package comes first: without it nothing below can run
    from sage_tpu_torch.ops import _cuda_build, pallas_sort, pallas_stage1
    from sage_tpu_torch.ops import batch_prep as tprep
    from sage_tpu_torch.ops import narrow_banded as tbanded
    from sage_tpu_torch.ops import rescore as trescore
    from sage_tpu_torch.ops import open_search as topen
    from sage_tpu_torch.ops import search as tsearch

    t_start = time.perf_counter()
    times = {}
    host_packages = host_packages_phase(times)
    # ---- 1. device
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    smi = nvidia_smi_line()
    kind = torch.cuda.get_device_name(0)
    log(f"# device: {kind} (nvidia-smi: {smi}), count "
        f"{torch.cuda.device_count()}, torch {torch.__version__}, "
        f"cuda {torch.version.cuda}")
    dev = torch.device("cuda")

    with Phase("2_build", times):
        build_s = build_kernels(_cuda_build)

    with tempfile.TemporaryDirectory() as tmp:
        runner_rec, runner, spectra = runner_phase(torch, pallas_stage1,
                                                   tmp, times)
        search11 = runner.parameters
        with open(os.path.join(search11.output_directory,
                               "results.sage.tsv"), "rb") as f:
            tsv11 = f.read()
        tdf_rec = tdf_phase(torch, pallas_stage1, runner, spectra, tmp,
                            host_packages["pyarrow"], times)
        mp_rec = multiprocess_phase(torch, pallas_stage1, runner, spectra,
                                    tmp, times)
        grid_runner = sharded_runner_phase(torch, pallas_stage1, runner,
                                           search11, tsv11, tmp, dev, times)
        db = runner.database
        del runner
        # the rescore's inputs on the main paths, for phase 25
        rescore_in = {}
        # the peak-major kernels' inputs on the open and banded paths, for
        # phase 27
        peak_in = {"open": {}, "two_dispatch_open": {}, "banded": {},
                   "banded_lowres": {}}
        narrow, k_stage1, k_prep, narrow_fused = narrow_phases(
            torch, tsearch, pallas_stage1, db, spectra, dev, times,
            rescore_in)
        open_rec, k_sort, open_fused = open_phases(
            torch, tsearch, topen, pallas_sort, db, spectra, dev, times,
            rescore_in, peak_in)
        cli_rec = cli_phase(torch, tmp, times)

    def reset_stage1():
        pallas_stage1.launches = 0
        trescore.launches = 0
        tprep.launches = 0

    def reset_sorts():
        for k in pallas_sort.launches:
            pallas_sort.launches[k] = 0
        trescore.launches = 0
        tprep.launches = 0
        reset_peak(topen)

    td_narrow = two_dispatch_phase(
        torch, tsearch, "13_two_dispatch_narrow", db, narrow_fused,
        "stage1_counts",
        (reset_stage1, lambda: {"stage1_counts": pallas_stage1.launches,
                                "rescore": trescore.launches,
                                "batch_prep": tprep.launches}),
        times, capture=(rescore_in, "two_dispatch"))
    td_open = two_dispatch_phase(
        torch, tsearch, "14_two_dispatch_open", db, open_fused, "row_sort",
        (reset_sorts, lambda: {**pallas_sort.launches, **topen.launches,
                               "rescore": trescore.launches,
                               "batch_prep": tprep.launches}),
        times, open_search=True,
        peak_capture=(topen, peak_in["two_dispatch_open"]))
    assert all(td_open["launches_all"][k] > 0 for k in PEAK_KERNELS), (
        td_open["launches_all"])
    # one batch_prep a batch on the two-dispatch paths too
    for td, fused in ((td_narrow, narrow_fused), (td_open, open_fused)):
        assert td["launches_all"]["batch_prep"] == len(fused[1]), (
            td["launches_all"])

    mods = {"search": tsearch, "banded": tbanded, "open": topen,
            "sort": pallas_sort, "stage1": pallas_stage1,
            "rescore": trescore}
    grid = sharded_phases(torch, mods, db, narrow_fused, open_fused, dev,
                          times)
    banded = banded_phase(torch, mods, db, spectra, times,
                          "15_banded", [("ppm", -10.0, 10.0)],
                          cpu_spectra=64, peak_in=peak_in["banded"])
    lowres = banded_phase(torch, mods, db, spectra, times,
                          "16_banded_lowres",
                          [("da", -0.5, 0.5), ("da", -1.0, 1.0)], lowres=True,
                          capture=(rescore_in, "banded_lowres"),
                          peak_in=peak_in["banded_lowres"])
    crossover = crossover_phase(torch, mods, db, spectra, times)
    chim = chimera_phase(torch, tsearch, pallas_stage1, db, times)
    rescore_rows = rescore_phase(torch, trescore, rescore_in, dev, times)
    del rescore_in
    peak_rows = peak_phase(torch, topen, tbanded, peak_in, dev, times)
    del peak_in
    large = large_peaks_phase(torch, mods, db, times)
    n_pep, n_frag = len(db), int(db.num_fragments)
    del db, spectra
    with tempfile.TemporaryDirectory() as tmp:
        lfq_rec = lfq_phase(torch, pallas_stage1, tmp, times)

    # ---- 10. result lines
    k_stage1["large_peaks"] = large["stage1"]
    k_stage1["launches_by_path"] = {
        "narrow_fused": k_stage1["launches"],
        "runner": runner_rec["stage1_launches"],
        "runner_tdf": tdf_rec["stage1_launches"],
        "multiprocess": sum(mp_rec["stage1_launches"]),
        "two_dispatch_narrow": td_narrow["launches"],
        "chimera": chim["launches"],
        "banded_reference": banded["reference_stage1_launches"],
        "sharded_narrow": grid["stage1_launches"],
        "sharded_runner": grid_runner["stage1_launches"],
        "large_peaks_fused": large["launches"]["1"]["stage1_counts"],
        "large_peaks_two_dispatch": large["launches"]["0"]["stage1_counts"]}
    k_row = k_sort[0]
    k_row["launches_by_path"] = {
        "open_fused": k_row["launches"],
        "two_dispatch_open": td_open["launches_all"]["row_sort"],
        "banded": banded["launches"]["row_sort"],
        "banded_lowres": lowres["launches"]["row_sort"],
        "sharded_open": grid["sort_launches"]["row_sort"]}
    k_row.update({f"banded_{k}": banded["sort"][k]
                  for k in ("ms", "plain_ms", "library_ms", "bound_ms")})
    # the cluster kernel's main path is the low-resolution banded batch
    # (rows past 2^15 keys); phase 8's open rows of 2^16 keys and phase 7's
    # lowered-limit run stay beside it
    c16, k_open_cl = lowres["cluster"], k_sort[1]
    k_cluster = {
        "name": "cluster_sort",
        "launches": lowres["launches"]["cluster_sort"], "max_abs_err": 0,
        **{k: c16[k] for k in ("ms", "plain_ms", "library_ms", "bound_ms",
                               "bound_by", "bound_share", "ctas",
                               "active_clusters")},
        "open16_ms": k_open_cl["open16_ms"],
        "open16_bound_ms": k_open_cl["open16_bound_ms"],
        "forced_launches": k_open_cl["forced_launches"],
        "forced_ms": k_open_cl["forced_ms"],
        "launches_by_path": {
            "banded_lowres": lowres["launches"]["cluster_sort"],
            "open_fused": k_open_cl["launches"],
            "two_dispatch_open": td_open["launches_all"]["cluster_sort"],
            "sharded_open": grid["sort_launches"]["cluster_sort"]},
    }
    # the rescore's main path is phase 3's narrow batch; its rows at the
    # other captured inputs stay beside it
    r3 = rescore_rows["narrow"]
    k_rescore = {
        "name": "rescore", "launches": narrow["rescore_launches"],
        "max_abs_err": 0,
        **{k: r3[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by",
                              "bound_share", "scan_bound_ms",
                              "scan_bound_share", "real_bound_ms",
                              "real_bound_by", "real_bound_share",
                              "plain_host_ms", "kernel_host_ms")},
        "library_ms": None,
        "by_input": rescore_rows,
        "launches_by_path": {
            "narrow_fused": narrow["rescore_launches"],
            "open_fused": open_rec["rescore_launches"],
            "runner": runner_rec["rescore_launches"],
            "runner_tdf": tdf_rec["rescore_launches"],
            "two_dispatch_narrow": td_narrow["launches_all"]["rescore"],
            "two_dispatch_open": td_open["launches_all"]["rescore"],
            "banded": banded["rescore_launches"],
            "banded_lowres": lowres["rescore_launches"],
            "chimera": chim["rescore_launches"],
            "sharded": grid["rescore_launches"],
            "sharded_runner": grid_runner["rescore_launches"],
            "large_peaks_fused": large["launches"]["1"]["rescore"],
            "large_peaks_two_dispatch": large["launches"]["0"]["rescore"]},
        "large_peaks": large["rescore"],
    }
    # the peak-major kernels' main path is phase 6's open batch; their
    # rows at phases 15's and 16's banded inputs stay beside it
    k_peak = []
    for name in PEAK_KERNELS:
        main = peak_rows[name]["open"]
        k_peak.append({
            "name": name, "launches": open_rec["peak_launches"][name],
            "max_abs_err": 0,
            **{k: main[k] for k in ("ms", "plain_ms", "bound_ms",
                                    "bound_by", "bound_share",
                                    "library_ms")},
            "by_input": peak_rows[name],
            "launches_by_path": {
                "open_fused": open_rec["peak_launches"][name],
                "two_dispatch_open": td_open["launches_all"][name],
                "banded": banded["peak_launches"][name],
                "banded_lowres": lowres["peak_launches"][name],
                "sharded_open": grid["peak_launches"][name]},
        })
    # the batch-prep kernel's main path is phase 3's narrow batch; the
    # paths that keep the host's prep (17, 22-24) read 0
    k_prep["launches_by_path"] = {
        "narrow_fused": narrow["prep_launches"],
        "open_fused": open_rec["prep_launches"],
        "runner": runner_rec["prep_launches"],
        "runner_tdf": tdf_rec["prep_launches"],
        "two_dispatch_narrow": td_narrow["launches_all"]["batch_prep"],
        "two_dispatch_open": td_open["launches_all"]["batch_prep"],
        "banded": banded["prep_launches"],
        "banded_lowres": lowres["prep_launches"],
        "chimera": chim["prep_launches"],
        "sharded": grid["prep_launches"],
        "sharded_runner": grid_runner["prep_launches"],
        "large_peaks_fused": large["launches"]["1"]["batch_prep"],
        "large_peaks_two_dispatch": large["launches"]["0"]["batch_prep"]}
    kernels = {"kernels": []}
    for k in (k_stage1, k_row, k_cluster, k_rescore, *k_peak, k_prep):
        src, replaces = KERNELS[k["name"]]
        kernels["kernels"].append({
            "name": k["name"], "route": "cuda", "source": src,
            "replaces": replaces, **{key: v for key, v in k.items()
                                     if key != "name"},
        })
    record = {
        "device": kind, "nvidia_smi": smi, "proteins": PROTEINS,
        "peptides": n_pep, "fragments": n_frag,
        "kernel_build_s": build_s, "phase_s": times,
        "host_packages": host_packages, "runner": runner_rec,
        "runner_tdf": tdf_rec, "multiprocess": mp_rec,
        "narrow": narrow, "open": open_rec, "cli": cli_rec,
        "two_dispatch_narrow": td_narrow, "two_dispatch_open": td_open,
        "banded": banded, "banded_lowres": lowres, "crossover": crossover,
        "chimera": chim, "sharded": grid, "sharded_runner": grid_runner,
        "large_peaks": large, "lfq": lfq_rec, **kernels,
    }
    record["total_s"] = time.perf_counter() - t_start
    log(f"# chip_smoke: {record['total_s']:.1f} s in all, the build included")
    log("# record: " + json.dumps(record, default=str))
    print(json.dumps(kernels), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
