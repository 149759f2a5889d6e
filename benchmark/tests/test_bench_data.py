"""The harness is driven by data: a copy of the benchmark gains a
configuration, a traffic mix and a per-layer metric reader as new files
and entries in ``BENCHMARK.json``, and the new cell runs at a tiny size
on the CPU with its new metric in the line. No file under ``benchmark/``
changes."""

import hashlib
import json
import os
import shutil
import subprocess
import sys
import textwrap

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(os.path.dirname(HERE))


def _digests(root):
    out = {}
    for d, _, files in os.walk(os.path.join(root, "benchmark")):
        if "__pycache__" in d:
            continue
        for f in files:
            p = os.path.join(d, f)
            with open(p, "rb") as fh:
                out[os.path.relpath(p, root)] = hashlib.sha1(fh.read()).hexdigest()
    return out


def test_new_cell_from_files_alone(tmp_path):
    work = tmp_path / "tree"
    shutil.copytree(os.path.join(ROOT, "benchmark"), work / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), work / "BENCHMARK.json")
    before = _digests(str(work))

    cfg = json.load(open(work / "benchmark/configs/tmt11-narrow.json"))
    cfg["sage"]["precursor_tol"] = {"ppm": [-10, 10]}
    cfg["sage"]["database"]["static_mods"] = {"C": 57.0215}
    (work / "benchmark/configs/mini-narrow.json").write_text(json.dumps(cfg))
    mix = json.load(open(work / "benchmark/traffic/search.json"))
    mix["charges"], mix["charge_weights"] = [2], [1.0]
    (work / "benchmark/traffic/charge2.json").write_text(json.dumps(mix))
    (work / "benchmark/metrics/tables_seen.py").write_text(textwrap.dedent('''
        """Tables the window yielded (a count, for this test)."""


        def read(facts, cell):
            return float(facts["tables"])
    '''))
    bench = json.loads((work / "BENCHMARK.json").read_text())
    bench["configs"].append({
        "name": "mini-narrow", "source": "https://example.org/mini",
        "file": "benchmark/configs/mini-narrow.json", "reduced": [],
        "why": "a test configuration"})
    bench["workloads"].append({
        "name": "mini-narrow.charge2", "config": "mini-narrow",
        "traffic": "charge2", "chips": 1, "why": "a test cell"})
    bench["end_to_end"][0]["workloads"].append("mini-narrow.charge2")
    bench["per_layer"].append({
        "name": "tables_seen", "unit": "tables", "better": "higher",
        "source": "program_counter", "layer": "search",
        "moves": "search_spectra_per_s", "workloads": ["mini-narrow.charge2"]})
    (work / "BENCHMARK.json").write_text(json.dumps(bench))

    code = textwrap.dedent("""
        import json, sys
        sys.path.insert(0, %r)  # the program under test
        sys.path.insert(0, %r)  # the copy's benchmark, found first
        from benchmark import run
        assert run.HERE.startswith(sys.path[0])
        for trace in (False, True):
            r = run.run_cell("mini-narrow.charge2", 9, 0.2, trace, device="cpu",
                             root=%r, proteome={"proteins": 150},
                             mix_over={"batch": 40, "judge_per_batch": 16},
                             n_spectra=80, warmup=False)
            print(json.dumps({k: r[k] for k in ("correct", "metrics")}))
    """) % (ROOT, str(work), str(work))
    p = subprocess.run([sys.executable, "-c", code], cwd=str(work),
                       capture_output=True, text=True, timeout=600)
    assert p.returncode == 0, p.stderr[-3000:]
    lines = [json.loads(x) for x in p.stdout.strip().splitlines()[-2:]]
    assert all(x["correct"] for x in lines)
    assert "search_spectra_per_s" in lines[0]["metrics"]
    assert lines[1]["metrics"]["tables_seen"]["value"] >= 1
    after = _digests(str(work))
    assert {k: v for k, v in after.items() if k in before} == before
