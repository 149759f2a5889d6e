"""The two drivers a traffic file can name: ``search`` (a pool of batches
cycled through ``Scorer.score_stream``) and ``runner`` (whole
``Runner.run()`` calls on one mzML file).

Each driver does the set-up (inputs from the seed, the program's
database, warm-up of every shape the window uses), measures for the
asked seconds, optionally under the profiler, and then judges what the
window produced with the reference. It returns a :class:`Outcome`; the
entry point (``run.py``) turns it into the result line.
"""

from __future__ import annotations

import dataclasses
import gc
import os
import shutil
import tempfile
import time
from typing import Callable, Dict, List, Optional

import numpy as np

from . import reference, roofline, traffic
from .trace import Spans


@dataclasses.dataclass
class Outcome:
    """What one run measured and judged."""

    e2e: Dict[str, float]
    checks: Dict[str, float]
    attempted: int
    failed: int
    peak_bytes: int
    spans: Spans
    facts: Dict[str, object]  # inputs of the per-layer metric readers
    trace: Optional[dict] = None


class Window:
    """Times the window and, when traced, runs it under the profiler."""

    def __init__(self, torch_mod, device: str, trace: bool):
        self.torch = torch_mod
        self.device = device
        self.trace = trace
        self.prof = None
        self.t0 = self.t1 = 0

    def sync(self):
        if self.device != "cpu":
            self.torch.cuda.synchronize()

    def __enter__(self):
        self.sync()
        if self.device != "cpu":
            self.torch.cuda.reset_peak_memory_stats()
        if self.trace and self.device != "cpu":
            from torch.profiler import ProfilerActivity, profile
            self.prof = profile(activities=[ProfilerActivity.CPU,
                                            ProfilerActivity.CUDA])
            self.prof.__enter__()
        self.t0 = time.time_ns()
        return self

    def __exit__(self, *exc):
        self.sync()
        self.t1 = time.time_ns()
        if self.prof is not None:
            self.prof.__exit__(*exc)
        return False

    @property
    def seconds(self) -> float:
        return (self.t1 - self.t0) / 1e9

    def peak_bytes(self) -> int:
        if self.device == "cpu":
            return 0
        return int(self.torch.cuda.max_memory_allocated())

    def reduce(self, spans: Spans) -> Optional[dict]:
        if self.prof is None:
            return None
        from .trace import device_intervals, reduce
        return reduce(device_intervals(self.prof), self.t0, self.t1, spans)


def _reference_peaks(spec, top_n: int):
    """The reference's own processing of a spectrum's peaks: neutral f32
    masses at charge 1, the ``top_n`` most intense, by ascending mass."""
    mass = traffic.processed_masses(spec.mz)
    inten = spec.intensity.astype(np.float32)
    if mass.size > top_n:
        keep = np.lexsort((mass, inten))[::-1][:top_n]
        mass, inten = mass[keep], inten[keep]
    order = np.argsort(mass, kind="stable")
    return mass[order], inten[order]


def _settle() -> None:
    """Collect set-up's garbage before the window opens, so that the
    window does not pay for it."""
    gc.collect()


def _sample(rng, n: int, k: int) -> np.ndarray:
    return np.sort(rng.choice(n, size=min(k, n), replace=False))


# ---------------------------------------------------------------------------


def run_search(config: dict, mix: dict, seed: int, seconds: float,
               trace: bool, device: str, torch_mod, program,
               n_spectra: Optional[int] = None,
               control: bool = False,
               fault: Optional[Callable] = None,
               warmup: bool = True) -> Outcome:
    """``n_spectra`` shrinks the pool and ``warmup=False`` skips the
    warm-up, for tests on the CPU; ``fault`` (tests only) rewrites each
    table the program yields; ``control`` judges the control's features
    in place of the program's."""
    spans = Spans()
    sage = config["sage"]
    batch = int(mix["batch"])
    with spans.span("inputs"):
        work = traffic.generate(config, mix, seed, n_spectra)
    tmp = tempfile.mkdtemp(prefix="sage-bench-")
    try:
        search = program.search_settings(
            sage, os.path.join(tmp, "db.fasta"), [os.path.join(tmp, "none.mzML")],
            os.path.join(tmp, "out"))
        with spans.span("db_build"):
            db = program.build_database(search, work.fasta)
        scorer = program.make_scorer(search, db, device)
        top_n = program.settings_top_n(search)
        pool_specs = [work.spectra[i:i + batch]
                      for i in range(0, len(work.spectra), batch)]
        pool = [program.processed(b, top_n) for b in pool_specs]
        # warm-up: the pool at least once, and for the traffic's
        # warm-up seconds, so that the window starts in a steady state
        with spans.span("warmup"):
            until = time.monotonic() + float(mix.get("warmup_seconds", 0.0))
            while warmup:
                for _ in program.score_stream(scorer, pool):
                    pass
                if time.monotonic() >= until:
                    break
        # the window: the pool handed to score_stream as one file, again
        # and again until the time is up (as the Runner hands it a file)
        tables: List[tuple] = []
        calls = 0
        _settle()
        with Window(torch_mod, device, trace) as win:
            deadline = win.t0 + int(seconds * 1e9)
            while time.time_ns() < deadline:
                handed: Dict[int, int] = {}

                def feed():
                    for i, b in enumerate(pool):
                        handed[i] = time.time_ns()
                        yield b

                t_a = time.time_ns()
                for i, table in enumerate(program.score_stream(scorer, feed())):
                    t_b = time.time_ns()
                    spans.add("batch", handed[i], t_b)
                    tables.append((i, program.keep(table, fault)))
                spans.add("score_stream", t_a, time.time_ns())
                calls += 1
        peak = win.peak_bytes()
        tr = win.reduce(spans)
        done = sum(len(pool[i]) for i, _ in tables)
        attempted = calls * sum(len(b) for b in pool)
        # judge a seeded sample of each pool batch in every table the
        # window yielded
        judge = reference.SearchJudge(sage)
        rng = np.random.default_rng([seed % (1 << 63), 0x7D6E])
        per = int(mix["judge_per_batch"])
        samples = [_sample(rng, len(b), per) for b in pool_specs]
        peaks = {}
        for i, t in tables:
            psms = program.top_psms(t, db, rows=samples[i])
            for j in samples[i]:
                spec = pool_specs[i][j]
                if spec.id not in peaks:
                    peaks[spec.id] = _reference_peaks(spec, top_n)
                m, it = peaks[spec.id]
                psm = psms.get(int(j))
                ctrl = (reference.control_scores(sage, spec, m, it, psm)
                        if control and psm is not None else None)
                judge.feed(spec, m, it, psm, ref_score=ctrl)
        checks = judge.numbers()
        checks["missing_tables"] = float(calls * len(pool) - len(tables))
        facts = {"window_start_ns": win.t0,
                 "call_s": spans.seconds("score_stream"),
                 "batch_s": spans.seconds("batch"),
                 "tables": len(tables), "pool": len(pool),
                 "first_wrong": judge.first_wrong}
        if tr is not None:
            facts["trace"] = tr
            if (sage["precursor_tol"].get("ppm") is not None):
                cands = roofline.Candidates(work.proteins, sage)
                counts = np.bincount([i for i, _ in tables],
                                     minlength=len(pool))
                tol = reference.tolerance(sage["precursor_tol"])
                total = {"ops": 0.0, "bytes": 0.0}
                for i, specs in enumerate(pool_specs):
                    w = roofline.narrow_work(
                        cands, specs, tol, sage.get("max_fragment_charge"),
                        lambda s: int(min(np.isfinite(s.mz).sum(), top_n)),
                        reference.isotope_range(sage))
                    total["ops"] += counts[i] * w["ops"]
                    total["bytes"] += counts[i] * w["bytes"]
                facts["narrow_work"] = total
        e2e = {"search_spectra_per_s": done / win.seconds,
               "peak_device_gib": peak / float(1 << 30)}
        return Outcome(e2e=e2e, checks=checks, attempted=attempted,
                       failed=attempted - done, peak_bytes=peak,
                       spans=spans, facts=facts, trace=tr)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


# ---------------------------------------------------------------------------


def judge_run(sage: dict, features, program, db, spectra_by_id: dict,
              sample_ids: List[str], proteins: "reference.Proteins",
              top_n: int, control: bool = False,
              lda_record: Optional[list] = None) -> Dict[str, float]:
    """Judge one ``run()`` call's PSM table: the sampled spectra's PSMs,
    then the discriminant, posterior errors and q-values of every PSM.
    ``lda_record`` (tests) gets each summation order's discriminant gap,
    by the order's name."""
    judge = reference.SearchJudge(sage)
    psms = program.top_psms(features, db, ids=set(sample_ids))
    for sid in sample_ids:
        spec = spectra_by_id[sid]
        m, it = _reference_peaks(spec, top_n)
        psm = psms.get(sid)
        ctrl = (reference.control_scores(sage, spec, m, it, psm)
                if control and psm is not None else None)
        judge.feed(spec, m, it, psm, ref_score=ctrl)
    out = judge.numbers()
    c = features.columns
    mods = reference.Mods(sage["database"])
    displays = program.displays(features, db)
    decoy = np.asarray(c["label"]) == -1
    keys, prot_keys, wrong_labels = [], [], 0
    for d, dec in zip(displays, decoy):
        pep = reference.parse_display(d, mods)
        target_seq = reference.reverse_interior(pep.seq) if dec else pep.seq
        target_sites = (pep.reversed(mods).var_sites if dec else pep.var_sites)
        keys.append((target_seq, target_sites))
        prots = proteins.of.get(target_seq)
        if prots is None:
            wrong_labels += 1
            prot_keys.append(None)
        else:
            prot_keys.append(tuple(prots))
    out["wrong_psms"] += float(wrong_labels)
    tol = reference.tolerance(sage["precursor_tol"])
    disc_p = np.asarray(c["discriminant_score"], np.float64)
    fits = [r for r in reference.lda_candidates(
        c, tol, bool(sage.get("predict_rt", True)), low=control) if r]
    if lda_record is not None:
        lda_record.append({r["name"]: float(np.max(np.abs(disc_p - r["disc"])))
                           for r in fits})
    if not fits:
        fits = [reference.heuristic_scores(c)]
    gaps = [float(np.max(np.abs(disc_p - r["disc"]))) for r in fits]
    ref = fits[int(np.argmin(gaps))]
    out["lda_gap"] = min(gaps)
    out["pep_gap"] = float(np.max(np.abs(
        np.asarray(c["posterior_error"], np.float64) - ref["pep"])))
    # the control's q-values are one precision below f32: bfloat16
    low = reference.bf16 if control else (lambda a: a)
    order = np.argsort(-ref["disc"], kind="stable")
    q = np.empty(len(order), np.float64)
    q[order] = low(reference.q_values(decoy[order]))
    out["spectrum_q_gap"] = float(np.max(np.abs(q - c["spectrum_q"])))
    score = ref["disc"].astype(np.float32)
    pq = reference.picked_q(keys, score, decoy)
    q_pep = low(np.array([pq[(k, bool(d))] for k, d in zip(keys, decoy)],
                         np.float32))
    out["peptide_q_gap"] = float(np.max(np.abs(q_pep - c["peptide_q"])))
    proteo = np.array([k is not None and len(k) == 1 for k in prot_keys])
    sel = np.flatnonzero(proteo)
    q_prot = np.ones(len(keys))
    if sel.size:
        qq = reference.picked_q([prot_keys[i] for i in sel], score[sel],
                                decoy[sel])
        q_prot[sel] = low(np.array(
            [qq[(prot_keys[i], bool(decoy[i]))] for i in sel], np.float32))
    out["protein_q_gap"] = float(np.max(np.abs(q_prot - c["protein_q"])))
    return out


def _judge_reporters(sage: dict, path: str, by_id: dict, ids: List[str],
                     top_n: int, control: bool) -> float:
    """The widest gap between the reporter intensities the last call
    wrote (``tmt.tsv``) and the reference's, over the sampled spectra; a
    sampled spectrum missing from the file reads as infinite."""
    from .traffic import TMT11_MZ

    got = {}
    with open(path) as f:
        next(f)
        for line in f:
            cols = line.rstrip("\n").split("\t")
            # each value is written as the shortest text of its f32
            got[cols[1]] = [float(np.float32(x)) for x in cols[3:]]
    gap = 0.0
    for sid in ids:
        m, it = _reference_peaks(by_id[sid], top_n)
        want = reference.reporter_ions(m, it, TMT11_MZ, ("ppm", -20.0, 20.0),
                                       low=control)
        have = got.get(sid)
        if have is None or len(have) != len(want):
            return float("inf")
        gap = max(gap, max(abs(a - b) for a, b in zip(have, want)))
    return gap


class _Instrument:
    """Spans around the Runner's calls into its layers, set on the
    instance so that ``run()`` goes through them."""

    def __init__(self, runner, spans: Spans, names: Dict[str, str]):
        for attr, name in names.items():
            fn = getattr(runner, attr, None)
            if fn is None:
                continue

            def wrapped(*a, _fn=fn, _name=name, **kw):
                with spans.span(_name):
                    return _fn(*a, **kw)
            setattr(runner, attr, wrapped)


def run_runner(config: dict, mix: dict, seed: int, seconds: float,
               trace: bool, device: str, torch_mod, program,
               n_spectra: Optional[int] = None, control: bool = False,
               fault: Optional[Callable] = None,
               warmup: bool = True, lda_record: Optional[list] = None) -> Outcome:
    spans = Spans()
    sage = config["sage"]
    with spans.span("inputs"):
        work = traffic.generate(config, mix, seed, n_spectra)
    tmp = tempfile.mkdtemp(prefix="sage-bench-")
    try:
        fasta = os.path.join(tmp, "db.fasta")
        mzml = os.path.join(tmp, "run.mzML")
        with open(fasta, "w") as f:
            f.write(work.fasta)
        traffic.write_mzml(mzml, work.spectra)
        search = program.search_settings(sage, fasta, [mzml],
                                         os.path.join(tmp, "out"),
                                         write_pin=bool(mix.get("write_pin")))
        with spans.span("db_build"):
            runner = program.new_runner(search, device)
        _Instrument(runner, spans, {"read_file": "read",
                                    "process_file": "search",
                                    "spectrum_fdr": "lda_fdr"})
        if warmup:
            with spans.span("warmup"):
                program.run(runner)
        results = []
        _settle()
        with Window(torch_mod, device, trace) as win:
            deadline = win.t0 + int(seconds * 1e9)
            while time.time_ns() < deadline:
                before = dict(runner.phases)
                with spans.span("run"):
                    res = program.run(runner)
                results.append((res["features"], {
                    k: runner.phases.get(k, 0.0) - before.get(k, 0.0)
                    for k in runner.phases}))
        peak = win.peak_bytes()
        tr = win.reduce(spans)
        n = len(work.spectra)
        db = program.runner_database(runner)
        rng = np.random.default_rng([seed % (1 << 63), 0x2B17])
        ids = [work.spectra[i].id for i in _sample(rng, n, int(mix["judge_spectra"]))]
        by_id = {s.id: s for s in work.spectra}
        proteins = reference.Proteins(work.proteins,
                                      sage["database"].get("enzyme") or {})
        top_n = program.settings_top_n(search)
        checks: Dict[str, float] = {}
        if search.quant.tmt is not None:
            checks["reporter_gap"] = _judge_reporters(
                sage, os.path.join(tmp, "out", "tmt.tsv"), by_id, ids, top_n,
                control)
        for features, _ in results:
            if fault is not None:
                features = fault(features)
            got = judge_run(sage, features, program, db, by_id, ids,
                            proteins, top_n, control=control,
                            lda_record=lda_record)
            for k, v in got.items():
                checks[k] = max(checks.get(k, 0.0), v)
        phases = [p for _, p in results]
        facts = {"window_start_ns": win.t0, "phases": phases,
                 "call_s": spans.seconds("run"), "calls": len(results)}
        if tr is not None:
            facts["trace"] = tr
        e2e = {"run_spectra_per_s": n * len(results) / win.seconds,
               "peak_device_gib": peak / float(1 << 30)}
        return Outcome(e2e=e2e, checks=checks, attempted=n * len(results),
                       failed=0, peak_bytes=peak, spans=spans, facts=facts,
                       trace=tr)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


DRIVERS = {"search": run_search, "runner": run_runner}
