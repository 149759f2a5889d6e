"""Command-line entry point of the PyTorch port.

Mirrors the reference CLI (crates/sage-cli/src/main.rs:12-105) and
``sage_tpu``'s, with the same flags: ``python -m sage_tpu_torch
<config.json> [mzml_paths...] [-f fasta] [-o output_directory]
[--annotate-matches] [--write-pin] [--batch-size N]``. The search runs on
the CUDA device and fails without one.
"""

from __future__ import annotations

import argparse
import json
import logging
import os
import sys


def main(argv=None) -> int:
    logging.basicConfig(
        level=os.environ.get("SAGE_LOG", "INFO").upper()
        if os.environ.get("SAGE_LOG", "INFO").upper() in ("DEBUG", "INFO", "WARNING", "ERROR", "TRACE")
        else "INFO",
        format="[%(asctime)s %(levelname)s %(name)s] %(message)s",
    )
    ap = argparse.ArgumentParser(
        prog="sage-tpu-torch",
        description=(
            "Proteomics search engine on an NVIDIA GPU - the PyTorch/CUDA "
            "port of sage_tpu, a re-implementation of the capabilities of "
            "Sage (lazear/sage)"
        ),
    )
    ap.add_argument("parameters", help="Path to configuration parameters (JSON file)")
    ap.add_argument(
        "mzml_paths", nargs="*",
        help="Paths to mzML files to process. Overrides mzml_paths in the config.",
    )
    ap.add_argument("-f", "--fasta", help="Path to FASTA database")
    ap.add_argument(
        "-o", "--output_directory",
        help="Path where search and quant results will be written",
    )
    ap.add_argument(
        "--batch-size", type=int, default=0,
        help="Number of files to load and search in parallel (default = # CPUs/2)",
    )
    ap.add_argument(
        "--mesh-shape", default=None, metavar="DATA,MODEL",
        help=(
            "Device-mesh shape for multi-device search, e.g. '4,2' = 4-way "
            "data x 2-way index parallel (default: every visible card on "
            "the data axis; '1,1' forces one device)"
        ),
    )
    ap.add_argument("--parquet", action="store_true", help="Write parquet output")
    ap.add_argument(
        "--annotate-matches", action="store_true",
        help="Write matched fragment annotations",
    )
    ap.add_argument("--write-pin", action="store_true", help="Write percolator .pin")
    ap.add_argument("--write-report", action="store_true", help="Write HTML QC report")
    ap.add_argument(
        "--disable-telemetry-i-dont-want-to-improve-sage", action="store_true",
        dest="disable_telemetry",
        help=(
            "Disable telemetry. Telemetry is only ever POSTed when the "
            "SAGE_TPU_TELEMETRY_URL environment variable is set; without "
            "it nothing is sent regardless of this flag"
        ),
    )
    args = ap.parse_args(argv)

    from .pipeline.input import build_search, load_config
    from .pipeline.runner import Runner

    cfg = load_config(args.parameters)
    search = build_search(
        cfg,
        fasta=args.fasta,
        mzml_paths=args.mzml_paths or None,
        output_directory=args.output_directory,
        write_pin=args.write_pin or None,
        write_report=args.write_report or None,
        annotate_matches=args.annotate_matches or None,
        parquet=args.parquet or None,
        mesh_shape=tuple(int(x) for x in args.mesh_shape.split(","))
        if args.mesh_shape else None,
        batch_size=args.batch_size or None,
    )
    runner = Runner(search)
    result = runner.run()
    print(json.dumps(search.to_json_dict(), indent=2))
    if not args.disable_telemetry and runner.process_id == 0:
        from .pipeline.telemetry import Telemetry

        Telemetry(
            search,
            peptides=len(runner.database) if runner.database else 0,
            fragments=(
                runner.database.num_fragments if runner.database else 0
            ),
            parquet=search.parquet,
            runtime_secs=result["run_time"],
        ).send()
    return 0


if __name__ == "__main__":
    sys.exit(main())
