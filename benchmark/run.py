"""Run one benchmark cell once and print its result line.

    python3 -m benchmark.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

The cell, its configuration and its end-to-end and per-layer metrics
come from ``BENCHMARK.json`` at the root of the checkout. A cell named
``<config>.<mix>`` reads ``benchmark/configs/<config>.json`` (the Sage
settings and the proteome's size) and ``benchmark/traffic/<mix>.json``
(the traffic's parameters and the driver that runs it); each per-layer
metric is read by ``benchmark/metrics/<metric>.py``. The run needs as
many CUDA devices as the cell asks for, and exits with an error and no
result line without them.

The last line of standard output is one JSON object: ``correct``,
``attempted``, ``failed``, ``metrics``, ``device`` and, traced,
``breakdown``, then ``checks``: every number the reference compared,
beside its limit (``benchmark/limits.json``). The checks are also the
last lines of standard error.
"""

from __future__ import annotations

import time

_T_START_WALL = time.time()

import argparse  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from typing import Dict, Optional  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
FORBIDDEN = ("jax", "jaxlib", "flax", "sage_tpu")


def load_bench(root: str = ".") -> dict:
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        return json.load(f)


def cell_spec(bench: dict, name: str, root: str = "."):
    """(workload entry, configuration, traffic mix) of a cell."""
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise SystemExit(f"unknown workload {name!r}; have {sorted(cells)}")
    cell = cells[name]
    conf = {c["name"]: c for c in bench["configs"]}[cell["config"]]
    with open(os.path.join(root, conf["file"])) as f:
        config = json.load(f)
    with open(os.path.join(HERE, "traffic", cell["traffic"] + ".json")) as f:
        mix = json.load(f)
    return cell, config, mix


def metrics_of(bench: dict, kind: str, cell: str):
    """The cell's metrics of one kind (``end_to_end`` or ``per_layer``)."""
    return [m for m in bench[kind]
            if "workloads" not in m or cell in m["workloads"]]


def read_metric(name: str, facts: dict, cell: str) -> Optional[float]:
    path = os.path.join(HERE, "metrics", name + ".py")
    spec = importlib.util.spec_from_file_location(
        "benchmark_metric_" + name.replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read(facts, cell)


def limits() -> Dict[str, float]:
    with open(os.path.join(HERE, "limits.json")) as f:
        return {k: float(v) for k, v in json.load(f)["limits"].items()}


def forbidden_modules():
    return sorted({m.split(".")[0] for m in list(sys.modules)
                   if m.split(".")[0] in FORBIDDEN})


def _num(x: float) -> float:
    """A JSON-safe number: a non-finite reading prints as 1e308."""
    return x if math.isfinite(x) else 1e308


def run_cell(name: str, seed: int, seconds: float, trace: bool,
             device: str = "cuda", root: str = ".",
             proteome: Optional[dict] = None, mix_over: Optional[dict] = None,
             **driver_kw) -> dict:
    """Run a cell and return its result object (without printing). The
    chip check is the caller's. ``proteome`` and ``mix_over`` shrink the
    cell for tests on the CPU."""
    import torch

    from . import program
    from .drivers import DRIVERS

    bench = load_bench(root)
    cell, config, mix = cell_spec(bench, name, root)
    config["proteome"].update(proteome or {})
    mix.update(mix_over or {})
    out = DRIVERS[mix["driver"]](config, mix, seed, seconds, trace, device,
                                 torch, program, **driver_kw)
    setup_s = (out.facts["window_start_ns"] / 1e9) - (_T_START_WALL)
    lim = limits()
    checks = {k: {"value": _num(v), "limit": lim[k]}
              for k, v in out.checks.items()}
    correct = all(c["value"] <= c["limit"] for c in checks.values())
    metrics: Dict[str, dict] = {}
    if not trace:
        values = dict(out.e2e, setup_s=setup_s)
        for m in metrics_of(bench, "end_to_end", name):
            if m["name"] in values:
                metrics[m["name"]] = {"value": values[m["name"]],
                                      "unit": m["unit"]}
    else:
        facts = dict(out.facts, spans=out.spans, setup_s=setup_s, e2e=out.e2e)
        for m in metrics_of(bench, "per_layer", name):
            v = read_metric(m["name"], facts, name)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    dev = {"platform": "gpu" if device != "cpu" else "cpu",
           "kind": (torch.cuda.get_device_name(0) if device != "cpu"
                    else "cpu"),
           "count": int(cell["chips"]),
           "memory_peak_bytes": int(out.peak_bytes)}
    result = {"correct": bool(correct), "attempted": int(out.attempted),
              "failed": int(out.failed), "metrics": metrics, "device": dev}
    if out.trace is not None:
        dev["busy_s"] = out.trace["busy_s"]
        dev["window_s"] = out.trace["window_s"]
        result["breakdown"] = {"device_ops": out.trace["device_ops"],
                               "idle_gaps": out.trace["idle_gaps"]}
    result["calls_s"] = [round(x, 4) for x in out.facts.get("call_s", [])][:64]
    result["checks"] = checks
    result["_why_not"] = out.facts.get("first_wrong")
    return result



def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    bench = load_bench()
    cell, _, _ = cell_spec(bench, args.workload)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
        print(f"benchmark: the cell needs {cell['chips']} CUDA device(s); "
              f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    result = run_cell(args.workload, args.seed, args.seconds,
                      bool(args.trace))
    bad = forbidden_modules()
    if bad:
        print(f"benchmark: the run loaded {', '.join(bad)}", file=sys.stderr)
        return 3
    why = result.pop("_why_not")
    if why and not result["correct"]:
        print(f"first wrong PSM: {why}", file=sys.stderr)
    for k, c in result["checks"].items():
        print(f"check {k} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stdout.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
