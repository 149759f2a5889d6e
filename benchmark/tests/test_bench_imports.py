"""What the benchmark may import. Nothing that ``python -m
benchmark.run`` loads has the top-level name ``jax``, ``jaxlib``,
``flax`` or ``sage_tpu`` (compared whole: ``sage_tpu_torch`` begins with
``sage_tpu`` and is the program under test). Of the benchmark's own
modules only the harness's call sites (``program.py``) import
``sage_tpu_torch``; the reference, the generator and the counts do not."""

import ast
import os
import subprocess
import sys
import textwrap

import pytest

HERE = os.path.dirname(os.path.abspath(__file__))
PKG = os.path.dirname(HERE)
ROOT = os.path.dirname(PKG)
CALL_SITES = {"program.py"}


def _imports(path):
    with open(path) as f:
        tree = ast.parse(f.read())
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            out.add(node.module.split(".")[0])
        elif isinstance(node, ast.Call) and getattr(node.func, "attr", "") == "import_module":
            if node.args and isinstance(node.args[0], ast.Constant):
                out.add(str(node.args[0].value).split(".")[0])
    return out


def _sources():
    for d, _, files in os.walk(PKG):
        if os.path.basename(d) == "tests":
            continue
        for f in files:
            if f.endswith(".py"):
                yield os.path.relpath(os.path.join(d, f), PKG)


@pytest.mark.parametrize("rel", sorted(_sources()))
def test_sources_import_no_jax_and_only_call_sites_the_program(rel):
    names = _imports(os.path.join(PKG, rel))
    assert not names & {"jax", "jaxlib", "flax", "sage_tpu"}, rel
    if rel not in CALL_SITES:
        assert "sage_tpu_torch" not in names, rel


def test_a_whole_run_loads_no_jax():
    code = textwrap.dedent("""
        import sys
        sys.path.insert(0, %r)
        sys.path.insert(0, %r)
        from _small import run_small
        r = run_small("tmt11-narrow.search", 5)
        assert r["correct"], r["checks"]
        from benchmark import run
        bad = run.forbidden_modules()
        assert "sage_tpu_torch" in sys.modules
        print("FORBIDDEN", bad)
    """) % (ROOT, HERE)
    env = dict(os.environ)
    env.pop("JAX_PLATFORMS", None)
    p = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                       capture_output=True, text=True, timeout=600)
    assert p.returncode == 0, p.stderr[-3000:]
    assert "FORBIDDEN []" in p.stdout


def test_forbidden_names_compare_whole():
    from benchmark import run

    saved = dict(sys.modules)
    try:
        sys.modules["sage_tpu_torch_fake"] = object()
        sys.modules["jaxfoo"] = object()
        for k in [k for k in sys.modules if k.split(".")[0] in run.FORBIDDEN]:
            del sys.modules[k]
        assert run.forbidden_modules() == []
        sys.modules["sage_tpu.ops"] = object()
        assert run.forbidden_modules() == ["sage_tpu"]
    finally:
        sys.modules.clear()
        sys.modules.update(saved)


def test_run_without_a_card_prints_no_result():
    p = subprocess.run(
        [sys.executable, "-m", "benchmark.run", "--workload",
         "tmt11-narrow.search", "--seed", "3", "--seconds", "1",
         "--trace", "0"],
        cwd=ROOT, capture_output=True, text=True, timeout=300,
        env=dict(os.environ, CUDA_VISIBLE_DEVICES=""))
    assert p.returncode != 0
    assert p.stdout.strip() == ""
