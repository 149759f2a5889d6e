"""Read the control's numbers for a cell on the card, at the cell's size.

    python3 -m benchmark.control --workload <cell> --seconds <s> --seeds <n> [<n> ...]

The control is the reference put in the program's place one precision
down (bfloat16 ion ladders for the search's features, float32 for the
discriminant and the densities). Each seed runs the cell whole (set-up,
a window of ``--seconds``) and prints one JSON line with the numbers
compared and ``correct``, which has to come out false. The benchmark's
own runs never run this.
"""

from __future__ import annotations

import argparse
import json
import sys

from . import run


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, default=3.0)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("control: needs a CUDA device", file=sys.stderr)
        return 2
    for seed in args.seeds:
        r = run.run_cell(args.workload, seed, args.seconds, False,
                         control=True)
        print(json.dumps({"seed": seed, "correct": r["correct"],
                          "checks": {k: v["value"]
                                     for k, v in r["checks"].items()}}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
