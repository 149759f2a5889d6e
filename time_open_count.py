"""Time the entry gather and the run-count top-K of one or more checkouts
of this repository on the same inputs, on one CUDA card.

Usage (from the repository root, on a machine with an NVIDIA H100):

    python3 time_open_count.py [TREE ...] [--reps N]

Each TREE is the root of a checkout (default: this one); its
``sage_tpu_torch/ops/open_search.py`` is loaded under a name of its own,
with its kernels built from that checkout's sources, and its
``open_entries`` and ``open_count`` are timed with CUDA events around
calls queued behind a spin kernel (``chip_smoke.queued_device_ms``), the
trees in the order given and then in reverse (A, B, B, A). A tree whose
``open_count`` takes no live counts (before they were passed from the
gather) is called without them. Every tree's outputs must equal the
plain versions'.

The inputs are the wrappers' arguments on the open search's paths whose
query rows span several band pseudo-rows (nbcov > 1), captured from the
first tree's search on bench.py's database (synth_fasta(20000), its
synthetic spectra, -500/+100 Da precursor and +-10 ppm fragments), at
the call with the most pseudo-rows a query row:
- ``two_dispatch``: the first 512-spectrum batch with SAGE_TPU_FUSED=0
  (``chip_smoke.py`` phase 14's input);
- ``host_planned``: a Scorer's first open batch of 512 spectra, planned
  on the host (phase 6's warm-up batch);
and, beside them, ``device_planned``: the next batch, planned on the
card (phase 7's input, nbcov 1). One JSON line at the end repeats the
numbers.
"""

from __future__ import annotations

import argparse
import importlib.util
import inspect
import json
import os
import sys
import tempfile
import time
import types

HERE = os.path.dirname(os.path.abspath(__file__))


def load_open(tree, tag):
    """``tree``'s open_search module (with the modules it imports at load
    time) as package ``tag``."""
    ops = os.path.join(tree, "sage_tpu_torch", "ops")
    pkg = types.ModuleType(tag)
    pkg.__path__ = [ops]
    sys.modules[tag] = pkg
    for name in ("_cuda_build", "pallas_sort", "pallas_stage1",
                 "open_search"):
        spec = importlib.util.spec_from_file_location(
            f"{tag}.{name}", os.path.join(ops, name + ".py"))
        mod = importlib.util.module_from_spec(spec)
        sys.modules[spec.name] = mod
        spec.loader.exec_module(mod)
    return sys.modules[f"{tag}.open_search"]


def capture(cs, torch):
    """path -> {"entries": (args, kw), "count": (args, kw)}, from the
    search of the ``sage_tpu_torch`` package on ``sys.path``."""
    from sage_tpu_torch.bench_baseline import synth_fasta, synth_spectra
    from sage_tpu_torch.chem.fasta import Fasta
    from sage_tpu_torch.ops import open_search as topen
    from sage_tpu_torch.ops import search as tsearch
    from sage_tpu_torch.pipeline.input import build_search

    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        fasta = os.path.join(tmp, "bench.fasta")
        with open(fasta, "w") as f:
            f.write(synth_fasta(cs.PROTEINS))
        dbp = build_search(cs.search_config(
            fasta, [os.path.join(tmp, "unread.mzML")])).database
        with open(fasta) as f:
            db = dbp.build(Fasta.parse(f.read(), dbp.decoy_tag,
                                       dbp.generate_decoys))
    b = cs.OPEN_BATCH
    spectra = synth_spectra(db, 2 * b)
    print(f"# db: {len(db)} peptides, {db.num_fragments} fragments, with "
          f"the spectra in {time.perf_counter() - t0:.1f} s", flush=True)
    params = tsearch.SearchParams(
        precursor_tol=tsearch.Tolerance("da", -500.0, 100.0),
        fragment_tol=tsearch.Tolerance("ppm", -10.0, 10.0))
    sets = {}

    def run(key, scorer, batch, widest=True):
        sets[key] = {}
        scorer._psm_counter = 1
        with cs.capture_peak(topen, None, sets[key], widest=widest):
            scorer.score_table(batch)
        torch.cuda.synchronize()
        return scorer.last_plan

    with cs.EnvSet("SAGE_TPU_FUSED", "0"):
        run("two_dispatch", tsearch.Scorer(db, params), spectra[:b])
    sc = tsearch.Scorer(db, params)
    plan = run("host_planned", sc, spectra[:b])
    assert plan.get("open") and not plan.get("device_planned"), plan
    plan = run("device_planned", sc, spectra[b:], widest=False)
    assert plan.get("device_planned"), plan
    return {k: {n: v[n] for n in ("entries", "count")}
            for k, v in sets.items()}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("trees", nargs="*", default=[HERE])
    ap.add_argument("--reps", type=int, default=10)
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("time_open_count: no CUDA device", file=sys.stderr)
        return 2
    trees = [os.path.abspath(t) for t in args.trees]
    sys.path.insert(0, HERE)
    import chip_smoke as cs

    sys.path.insert(0, trees[0])
    smi = cs.nvidia_smi_line()
    print(f"# device: {torch.cuda.get_device_name(0)} (nvidia-smi: {smi}); "
          f"inputs captured with {trees[0]}", flush=True)
    sets = capture(cs, torch)
    from sage_tpu_torch.ops import open_search as topen

    mods = [load_open(t, f"_tree{i}") for i, t in enumerate(trees)]
    rec = {"device": torch.cuda.get_device_name(0), "nvidia_smi": smi,
           "trees": trees, "sets": {}}
    order = list(range(len(trees))) + list(range(len(trees)))[::-1]
    for path, calls in sets.items():
        out = rec["sets"][path] = {}
        (e_args, e_kw), (c_args, c_kw) = calls["entries"], calls["count"]
        want_e = topen.open_entries_plain(*e_args, **e_kw)
        want_c = topen.open_count_plain(*c_args, **c_kw)
        cands = {}
        for mod, tree in zip(mods, trees):
            c_in = c_args
            if "live" not in inspect.signature(mod.open_count).parameters:
                c_in = c_args[:2] + c_args[3:]
            got_e = mod.open_entries(*e_args, **e_kw)
            for g, w in zip(got_e, want_e):
                assert (g is None and w is None) or torch.equal(g, w), (
                    path, tree, "open_entries")
            assert torch.equal(mod.open_count(*c_in, **c_kw), want_c), (
                path, tree, "open_count")
            cands[tree] = (
                lambda m=mod: m.open_entries(*e_args, **e_kw),
                lambda m=mod, a=c_in: m.open_count(*a, **c_kw))
        keys = want_e[0]
        live = int(want_e[2].long().sum())
        entries = int(want_c[:, 2 * c_kw["K"]].long().sum())
        what = dict(
            entries=f"rows {list(keys.shape)}, nbcov {e_kw['nbcov']}, Z "
                    f"{e_kw['Z']}, Pk {e_kw['Pk']}, chunked "
                    f"{e_kw['chunked']}, packed {e_kw['packed']}, {live} "
                    f"live entries",
            count=f"{want_c.shape[0]} query rows, nbcov {c_kw['nbcov']}, "
                  f"rows {list(c_args[0].shape)} cut to F {c_kw['F']}, K "
                  f"{c_kw['K']}, {entries} entries count")
        for i, name in enumerate(("entries", "count")):
            ms = {t: [] for t in trees}
            for j in order:
                ms[trees[j]].append(cs.queued_device_ms(
                    torch, cands[trees[j]][i], reps=args.reps))
            out[name] = {"input": what[name], "ms": ms}
            print(f"# {path} open_{name} ({what[name]}):", flush=True)
            for t in trees:
                print(f"#   {t}: {' / '.join(f'{m:.4f}' for m in ms[t])} "
                      f"ms", flush=True)
    print("# record: " + json.dumps(rec), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
