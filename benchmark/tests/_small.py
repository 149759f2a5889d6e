"""Cells cut to a size the CPU runs in seconds, for the tests.

The committed benchmark has no Runner cell, so :func:`runner_root`
writes a root of its own whose ``BENCHMARK.json`` adds Runner cells of
the ``tmt11-narrow`` configuration and of ``open-human`` (Sage's
``open.json`` settings, kept here in ``open-human.json`` until an open
cell returns to the benchmark)."""

import json
import os
import shutil

from benchmark import run

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(os.path.dirname(HERE))

SIZES = {
    "tmt11-narrow.search": dict(proteins=400, spectra=256),
    "tmt11-narrow.runner": dict(proteins=400, spectra=320),
    "open-human.runner": dict(proteins=300, spectra=320),
}


def runner_root(path) -> str:
    """A root holding ``BENCHMARK.json`` with the Runner cells and the
    configuration files it names; the traffic mixes and metric readers
    are the benchmark's own."""
    path = str(path)
    bench = run.load_bench(ROOT)
    os.makedirs(os.path.join(path, "benchmark", "configs"), exist_ok=True)
    shutil.copy(os.path.join(ROOT, "benchmark/configs/tmt11-narrow.json"),
                os.path.join(path, "benchmark/configs/tmt11-narrow.json"))
    shutil.copy(os.path.join(HERE, "open-human.json"),
                os.path.join(path, "benchmark/configs/open-human.json"))
    bench["configs"].append({
        "name": "open-human", "file": "benchmark/configs/open-human.json",
        "source": "https://github.com/lazear/sage/blob/master/figures/benchmark_params/open.json",
        "reduced": ["proteome"], "why": "open search"})
    for conf in ("tmt11-narrow", "open-human"):
        bench["workloads"].append({
            "name": conf + ".runner", "config": conf, "traffic": "runner",
            "chips": 1, "why": "Runner.run() on one mzML"})
    bench["end_to_end"].append({
        "name": "run_spectra_per_s", "unit": "spectra/s", "better": "higher",
        "bound": 0.25, "source": "host_clock",
        "workloads": ["tmt11-narrow.runner", "open-human.runner"]})
    with open(os.path.join(path, "BENCHMARK.json"), "w") as f:
        json.dump(bench, f)
    return path


def run_small(cell, seed, root=ROOT, warmup=False, **kw):
    size = SIZES.get(cell, dict(proteins=200, spectra=128))
    mix = {"judge_per_batch": 64, "judge_spectra": 96}
    if cell.endswith(".search"):
        mix["batch"] = size["spectra"] // 2
    return run.run_cell(cell, seed, 0.2, trace=False, device="cpu",
                        root=root, proteome={"proteins": size["proteins"]},
                        mix_over=mix, n_spectra=size["spectra"],
                        warmup=warmup, **kw)
