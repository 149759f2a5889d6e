"""sage_tpu_torch — the PyTorch / CUDA port of sage_tpu for NVIDIA Hopper.

The same search engine as ``sage_tpu``, with the device path written in
PyTorch and its hand kernels in CUDA for sm_90a. Module paths and names
mirror ``sage_tpu`` so each module's counterpart is easy to find. The
package imports torch and numpy only; it never imports jax or
``sage_tpu``.

Covered so far: the command line (``python -m sage_tpu_torch
config.json``) and its ``Runner``: database build (with the prefilter
mode), mzML / MGF / Bruker timsTOF .d reading, spectrum processing, the
narrow, banded, chimeric and open searches (``Scorer.score_table`` /
``Scorer.score_stream``) through the fused and the two-dispatch paths,
RT / mobility prediction, LDA rescoring, FDR, protein grouping, TMT and
label-free quant, the TSV / PIN / parquet / JSON outputs and the HTML
report, in one process or several (``maybe_init_distributed``), on one
device or on a ("data", "model") grid of devices (``ShardedScorer``,
``make_mesh``).
"""

__version__ = "0.1.0"

__all__ = [
    "DatabaseParams",
    "IndexedDatabase",
    "Scorer",
    "SearchParams",
    "ShardedScorer",
    "make_mesh",
    "Runner",
    "maybe_init_distributed",
    "build_search",
    "load_config",
    "save_database",
    "load_database",
]


def __getattr__(name):
    # Lazy re-exports: importing the package does not import torch until
    # a search-facing symbol is touched.
    if name in ("DatabaseParams", "IndexedDatabase", "save_database", "load_database"):
        from .index import builder

        return getattr(builder, name)
    if name in ("Scorer", "SearchParams"):
        from .ops import search

        return getattr(search, name)
    if name in ("ShardedScorer", "make_mesh"):
        from .parallel import sharding

        return getattr(sharding, name)
    if name == "Runner":
        from .pipeline.runner import Runner

        return Runner
    if name == "maybe_init_distributed":
        from .parallel.multihost import maybe_init_distributed

        return maybe_init_distributed
    if name in ("build_search", "load_config"):
        from .pipeline import input as _input

        return getattr(_input, name)
    raise AttributeError(name)
