"""Time the long-row sort of one or more checkouts of this repository on
the same rows, on one CUDA card.

Usage (from the repository root, on a machine with an NVIDIA H100):

    python3 time_long_sort.py [TREE ...] [--slices N ...]

Each TREE is the root of a checkout (default: this one); its
``sage_tpu_torch/ops/pallas_sort.py`` is loaded under a name of its own,
with its kernels built from that checkout's sources, and its
``bitonic_sort_rows`` is timed with CUDA events on every row set, the
trees in the order given and then in reverse (A, B, B, A), beside
``torch.sort`` and the card's bound (each key read and written once at
3.35 TB/s). Every tree's output must equal ``torch.sort``'s.

The rows are those ``chip_smoke.py`` gives the long-row sort, captured
from the first tree's search on bench.py's database (synth_fasta(20000),
its 3 x 8192 synthetic spectra):
- phase 16's: the banded stage 1 forced at +-1.5 Da precursor and
  +-0.5 Da fragments, the entry rows of one 8192-spectrum batch after a
  warm-up batch (rows of 65,536 keys);
- phase 7's: the entry rows of a device-planned open batch (-500/+100 Da,
  512 spectra, after a warm-up batch), sorted with the one-pass limit
  ``_BLOCK_MAX`` lowered to 1024 keys.
``--slices N`` also times, for each tree whose pallas_sort has
``cluster_sort``, phase 16's rows in N slices a row, with the clusters'
occupancy. One JSON line at the end repeats the numbers.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import sys
import tempfile
import time
import types

HERE = os.path.dirname(os.path.abspath(__file__))


def load_sort(tree, tag):
    """``tree``'s pallas_sort module (and its _cuda_build) as package
    ``tag``."""
    ops = os.path.join(tree, "sage_tpu_torch", "ops")
    pkg = types.ModuleType(tag)
    pkg.__path__ = [ops]
    sys.modules[tag] = pkg
    for name in ("_cuda_build", "pallas_sort"):
        spec = importlib.util.spec_from_file_location(
            f"{tag}.{name}", os.path.join(ops, name + ".py"))
        mod = importlib.util.module_from_spec(spec)
        sys.modules[spec.name] = mod
        spec.loader.exec_module(mod)
    return sys.modules[f"{tag}.pallas_sort"]


def capture(cs, torch):
    """Phase 16's and phase 7's sort inputs, from the search of the
    ``sage_tpu_torch`` package on ``sys.path``."""
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
    spectra = synth_spectra(db, 3 * 8192)
    print(f"# db: {len(db)} peptides, {db.num_fragments} fragments, with "
          f"the spectra in {time.perf_counter() - t0:.1f} s", flush=True)

    def recorded(scorer, batch):
        rows = []
        scorer._psm_counter = 1
        with cs.Recording(topen, "bitonic_sort_rows",
                          lambda out, x, *a, **k: rows.append(x.clone())):
            scorer.score_table(batch)
        torch.cuda.synchronize()
        return rows

    B = cs.BANDED_BATCH
    with cs.EnvSet("SAGE_TPU_NARROW_BANDED", "1"):
        sc = tsearch.Scorer(db, tsearch.SearchParams(
            precursor_tol=tsearch.Tolerance(*cs.BANDED_PREC),
            fragment_tol=tsearch.Tolerance("da", -0.5, 0.5)))
        list(sc.score_stream([spectra[:B]]))
        rows16 = recorded(sc, spectra[B:2 * B])
    assert sc.last_plan.get("banded"), sc.last_plan
    del sc
    b = cs.OPEN_BATCH
    sc = tsearch.Scorer(db, tsearch.SearchParams(
        precursor_tol=tsearch.Tolerance("da", -500.0, 100.0),
        fragment_tol=tsearch.Tolerance("ppm", -10.0, 10.0)))
    list(sc.score_stream([spectra[:b]]))
    rows7 = recorded(sc, spectra[b:2 * b])
    assert sc.last_plan.get("device_planned"), sc.last_plan
    return {"phase16": rows16, "phase7": rows7}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("trees", nargs="*", default=[HERE])
    ap.add_argument("--slices", type=int, nargs="*", default=[])
    ap.add_argument("--reps", type=int, default=10)
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("time_long_sort: no CUDA device", file=sys.stderr)
        return 2
    trees = [os.path.abspath(t) for t in args.trees]
    sys.path.insert(0, HERE)
    import chip_smoke as cs

    sys.path.insert(0, trees[0])
    smi = cs.nvidia_smi_line()
    print(f"# device: {torch.cuda.get_device_name(0)} (nvidia-smi: {smi}); "
          f"rows captured with {trees[0]}", flush=True)
    sets = capture(cs, torch)
    mods = [load_sort(t, f"_tree{i}") for i, t in enumerate(trees)]
    lowered = {"phase16": None, "phase7": 1024}
    rec = {"device": torch.cuda.get_device_name(0), "nvidia_smi": smi,
           "trees": trees, "sets": {}}
    for name, xs in sets.items():
        shapes = [list(x.shape) for x in xs]
        real = sum(int((x != 2**31 - 1).sum()) for x in xs)
        nb = sum(cs.sort_work(*x.shape)[0] for x in xs)
        ops = sum(cs.sort_work(*x.shape)[1] for x in xs)
        bound, by = cs.bound_ms(nb, ops, cs.INT32_OPS_PER_S)
        want = [torch.sort(x, dim=1).values for x in xs]

        def run(mod):
            old = mod._BLOCK_MAX
            if lowered[name]:
                mod._BLOCK_MAX = lowered[name]
            try:
                return [mod.bitonic_sort_rows(x) for x in xs]
            finally:
                mod._BLOCK_MAX = old

        for mod, tree in zip(mods, trees):
            for g, w in zip(run(mod), want):
                assert torch.equal(g, w), (name, tree)
        ms = {t: [] for t in trees}
        for i in list(range(len(trees))) + list(range(len(trees)))[::-1]:
            ms[trees[i]].append(cs.exec_ms(lambda: run(mods[i]), args.reps))
        lib = cs.exec_ms(lambda: [torch.sort(x, dim=1) for x in xs],
                         args.reps)
        out = {"shapes": shapes, "real_keys": real, "bound_ms": bound,
               "bound_by": by, "torch_sort_ms": lib, "ms": ms}
        print(f"# {name}: {len(xs)} launches of {shapes}, {real} real keys "
              f"({real / (nb / 8):.3f} of all); bound {bound:.4f} ms ({by}),"
              f" torch.sort {lib:.4f} ms", flush=True)
        for t in trees:
            print(f"#   {t}: {' / '.join(f'{m:.4f}' for m in ms[t])} ms, "
                  f"share of bound {bound / min(ms[t]):.3f}", flush=True)
        if name == "phase16":
            out["slices"] = {}
            for mod, tree in zip(mods, trees):
                if not hasattr(mod, "cluster_sort"):
                    continue
                for n in args.slices:
                    F = xs[0].shape[1]
                    blk = -(-F // n)
                    C, G, act, smem = mod.cluster_occupancy(
                        xs[0].shape[0], F, blk)
                    for x, w in zip(xs, want):
                        assert torch.equal(mod.cluster_sort(x, blk), w)
                    t = [cs.exec_ms(lambda: [mod.cluster_sort(x, blk)
                                             for x in xs], args.reps)
                         for _ in range(2)]
                    out["slices"][f"{tree}:{C}"] = dict(
                        C=C, G=G, active_clusters=act, smem_bytes=smem, ms=t)
                    print(f"#   {tree}: {C} slices (chunks of {G}, {smem} "
                          f"shared bytes a CTA, {act} active clusters): "
                          f"{t[0]:.4f} / {t[1]:.4f} ms", flush=True)
        rec["sets"][name] = out
    print("# record: " + json.dumps(rec), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
