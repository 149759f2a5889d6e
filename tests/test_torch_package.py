"""Package rules of the PyTorch port: it imports without jax and without
sage_tpu, imports neither anywhere, and never quietly falls back to the
CPU."""

import os
import re
import subprocess
import sys

import jax  # noqa: F401  (conftest keeps JAX on the CPU)
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(REPO, "sage_tpu_torch")

_IMPORT_RE = re.compile(
    r"^\s*(?:import\s+(?:jax|sage_tpu)\b|from\s+(?:jax|sage_tpu)\b)",
    re.MULTILINE,
)


def _port_files():
    out = [os.path.join(REPO, "chip_smoke.py")]
    for root, dirs, files in os.walk(PKG):
        # build/ holds the kernels' build outputs, not the package's source
        dirs[:] = [d for d in dirs if d != "build"]
        out +=[os.path.join(root, f) for f in files if f.endswith(".py")]
    return out


def test_imports_with_jax_and_sage_tpu_blocked():
    code = (
        "import sys\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['sage_tpu'] = None\n"
        "import sage_tpu_torch.ops.search\n"
        "import sage_tpu_torch.ops.pallas_stage1\n"
        "import sage_tpu_torch.ops.rescore\n"
        "import sage_tpu_torch.ops.pallas_sort\n"
        "import sage_tpu_torch.ops.open_search\n"
        "import sage_tpu_torch.ops.narrow_banded\n"
        "import sage_tpu_torch.quant.lfq\n"
        "import sage_tpu_torch.pipeline.report\n"
        "import sage_tpu_torch.bench_baseline\n"
        "import sage_tpu_torch.index.builder\n"
        "import sage_tpu_torch.pipeline.runner\n"
        "import sage_tpu_torch.pipeline.parquet_out\n"
        "import sage_tpu_torch.io.tdf\n"
        "import sage_tpu_torch.parallel.multihost\n"
        "import sage_tpu_torch.parallel.sharding\n"
        "import sage_tpu_torch.utils.devprof\n"
        "import sage_tpu_torch.cli\n"
        "from sage_tpu_torch import (Runner, build_search, load_config,\n"
        "    maybe_init_distributed, ShardedScorer, make_mesh)\n"
        "assert 'jax' not in [m.split('.')[0] for m in sys.modules"
        " if sys.modules[m] is not None]\n"
        "print('ok')\n"
    )
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr
    assert r.stdout.strip().endswith("ok")


@pytest.mark.parametrize("path", _port_files(),
                         ids=lambda p: os.path.relpath(p, REPO))
def test_no_jax_or_sage_tpu_import(path):
    with open(path) as f:
        src = f.read()
    assert not _IMPORT_RE.findall(src), f"{path} imports jax or sage_tpu"


def test_import_check_catches_imports():
    assert _IMPORT_RE.search("import jax.numpy as jnp")
    assert _IMPORT_RE.search("    from sage_tpu.ops import search")
    assert not _IMPORT_RE.search("from sage_tpu_torch.ops import search")
    assert not _IMPORT_RE.search("import sage_tpu_torch")


def test_scorer_without_device_raises_when_cuda_absent(monkeypatch):
    import sage_tpu_torch.chem.mass as tmass
    from sage_tpu_torch.ops.search import Scorer, SearchParams

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    params = SearchParams(
        precursor_tol=tmass.Tolerance("ppm", -20.0, 20.0),
        fragment_tol=tmass.Tolerance("ppm", -10.0, 10.0),
    )
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Scorer(object(), params)


def test_make_scorer_choice(monkeypatch, tmp_path):
    """The Runner's scorer: a ShardedScorer for SAGE_TPU_MESH=2,1 (chimera
    included) and for a config mesh_shape, a Scorer for "1,1", the
    process's device count as the data axis when nothing is set, and a
    shape that needs more devices than the process has fails. Tests the
    process's devices are stood in for by the CPU four times."""
    from sage_tpu_torch.ops.search import Scorer
    from sage_tpu_torch.parallel import sharding
    from sage_tpu_torch.pipeline.input import build_search
    from sage_tpu_torch.pipeline.runner import Runner

    fasta = tmp_path / "tiny.fasta"
    fasta.write_text(">sp|P0|P0_SYN s\nMKAAGLLCPEDKRWAGHTEKLSTPQR\n")
    cfg = {"database": {"fasta": str(fasta)},
           "precursor_tol": {"ppm": [-20, 20]},
           "fragment_tol": {"ppm": [-10, 10]},
           "mzml_paths": [str(tmp_path / "run.mzML")]}
    r = Runner(build_search(cfg, output_directory=str(tmp_path / "out")),
               device="cpu")
    # without stand-ins the CPU Runner has one device
    monkeypatch.delenv("SAGE_TPU_MESH", raising=False)
    assert isinstance(r._make_scorer(), Scorer)
    r.parameters.mesh_shape = (2, 1)
    with pytest.raises(ValueError, match="need 2 devices, have 1"):
        r._make_scorer()
    r.parameters.mesh_shape = None

    monkeypatch.setattr(sharding, "local_devices",
                        lambda device="cuda": [torch.device("cpu")] * 4)
    monkeypatch.setenv("SAGE_TPU_MESH", "2,1")
    s = r._make_scorer()
    assert isinstance(s, sharding.ShardedScorer)
    assert s.mesh.shape == {"data": 2, "model": 1}
    r.parameters.chimera = True
    assert isinstance(r._make_scorer(), sharding.ShardedScorer)
    r.parameters.chimera = False
    monkeypatch.setenv("SAGE_TPU_MESH", "1,1")
    assert isinstance(r._make_scorer(), Scorer)
    monkeypatch.delenv("SAGE_TPU_MESH")
    r.parameters.mesh_shape = (1, 1)
    assert isinstance(r._make_scorer(), Scorer)
    r.parameters.mesh_shape = (2, 2)
    s = r._make_scorer()
    assert isinstance(s, sharding.ShardedScorer)
    assert s.mesh.shape == {"data": 2, "model": 2}
    r.parameters.mesh_shape = None
    assert r._make_scorer().mesh.shape == {"data": 4, "model": 1}
    r.parameters.mesh_shape = (4, 2)
    with pytest.raises(ValueError, match="need 8 devices, have 4"):
        r._make_scorer()


@pytest.mark.parametrize("name", ["Runner", "build_search", "load_config",
                                  "maybe_init_distributed", "ShardedScorer",
                                  "make_mesh"])
def test_lazy_exports(name):
    """The package's lazy exports, as sage_tpu has them: each resolves to
    its module's object and is listed in ``__all__``."""
    import sage_tpu_torch

    where = {"Runner": "pipeline.runner", "build_search": "pipeline.input",
             "load_config": "pipeline.input",
             "maybe_init_distributed": "parallel.multihost",
             "ShardedScorer": "parallel.sharding",
             "make_mesh": "parallel.sharding"}[name]
    mod = __import__(f"sage_tpu_torch.{where}", fromlist=[name])
    assert getattr(sage_tpu_torch, name) is getattr(mod, name)
    assert name in sage_tpu_torch.__all__
