"""The port's multi-process layer against sage_tpu's, on the CPU.

``shard_paths`` against sage_tpu's; ``maybe_init_distributed``'s
triggers; ``allgather_bytes`` over three gloo processes with 1 MiB
chunks; and a 2-process run of the port's Runner over three synthetic
mzML files with ``quant.lfq`` (process 0 gets files {0, 2}, process 1
gets {1}: an uneven shard, reassembled out of order, with MS1 spectra in
the gather), whose results.sage.tsv and lfq.tsv must be byte-equal to
the port's and sage_tpu's 1-process runs. Process 1 writes nothing.

This module is also the worker: ``python test_torch_multihost.py run
<config.json> <outdir>`` runs the port's Runner on the CPU, and
``python test_torch_multihost.py allgather`` gathers this rank's test
blob and ``python test_torch_multihost.py late <seconds>`` does so under
a rendezvous limit of that many seconds, with rank 1 that much and more
behind rank 0; each joins the process group its environment names.
Every wait has a limit: the process group's own and each subprocess's.
"""

import json
import os
import shutil
import socket
import subprocess
import sys

import numpy as np
import pytest

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)
# a subprocess that has not finished by then fails the test
SUBPROCESS_TIMEOUT_S = 180


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _run_group(args, n, extra_env=None):
    """Run this module as ``n`` worker processes of one gloo group on a
    free localhost port; returns their (stdout, stderr), asserting that
    each exited 0."""
    port = _free_port()
    procs = []
    for rank in range(n):
        env = dict(os.environ)
        env["PYTHONPATH"] = os.pathsep.join(
            [REPO] + [p for p in env.get("PYTHONPATH", "").split(os.pathsep)
                      if p])
        env.update({
            "SAGE_TPU_COORDINATOR": f"127.0.0.1:{port}",
            "SAGE_TPU_NUM_PROCS": str(n), "SAGE_TPU_PROC_ID": str(rank),
            **(extra_env or {}),
        })
        procs.append(subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), *args], env=env,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=SUBPROCESS_TIMEOUT_S))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for p, (out, err) in zip(procs, outs):
        assert p.returncode == 0, err[-3000:]
    return outs


@pytest.mark.parametrize("n,count", [(1, 1), (5, 1), (5, 2), (3, 2),
                                     (7, 3), (2, 4), (0, 2)])
def test_shard_paths_matches_sage_tpu(n, count):
    """Round-robin by file index with global file_ids, equal to
    sage_tpu's; the shards partition the files."""
    from sage_tpu.parallel.multihost import shard_paths as jshard
    from sage_tpu_torch.parallel.multihost import shard_paths

    paths = [f"f{i}.mzML" for i in range(n)]
    shards = [shard_paths(paths, pid, count) for pid in range(count)]
    assert shards == [jshard(paths, pid, count) for pid in range(count)]
    assert sorted(x for s in shards for x in s) == list(enumerate(paths))


def test_maybe_init_distributed_triggers(monkeypatch):
    """No trigger: (0, 1) and no process group. SAGE_TPU_DISTRIBUTED=1:
    the group forms from torchrun's variables (env://); a second call
    uses the group that exists."""
    import torch.distributed as dist

    from sage_tpu_torch.parallel import multihost

    for k in ("SAGE_TPU_COORDINATOR", "SAGE_TPU_DISTRIBUTED"):
        monkeypatch.delenv(k, raising=False)
    assert multihost.maybe_init_distributed() == (0, 1)
    assert not dist.is_initialized()
    assert multihost.allgather_bytes(b"abc") == [b"abc"]
    monkeypatch.setenv("SAGE_TPU_DISTRIBUTED", "1")
    monkeypatch.setenv("RANK", "0")
    monkeypatch.setenv("WORLD_SIZE", "1")
    monkeypatch.setenv("MASTER_ADDR", "127.0.0.1")
    monkeypatch.setenv("MASTER_PORT", str(_free_port()))
    try:
        assert multihost.maybe_init_distributed() == (0, 1)
        assert dist.is_initialized() and dist.get_backend() == "gloo"
        assert multihost.maybe_init_distributed() == (0, 1)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def _blob(rank: int) -> bytes:
    """Rank 0: 2.5 MiB; rank 1: empty; rank 2: 1 MiB + 17 bytes."""
    size = {0: 5 << 19, 1: 0, 2: (1 << 20) + 17}[rank]
    return np.random.default_rng(rank).integers(
        0, 256, size, dtype=np.uint8).tobytes()


def test_allgather_bytes_chunks():
    """Three processes gather blobs of unequal length, one empty, the
    others crossing 1 MiB chunk edges (SAGE_TPU_ALLGATHER_CHUNK_MB=1):
    each gets every blob back, in rank order."""
    outs = _run_group(["allgather"], 3, {"SAGE_TPU_ALLGATHER_CHUNK_MB": "1"})
    for rank, (out, _) in enumerate(outs):
        assert out.strip().splitlines()[-1] == f"allgather ok {rank} 3"


def test_gather_waits_for_a_late_shard():
    """The rendezvous limit does not bound the gather: under a 2 s
    rendezvous limit, rank 1 reaches the gather 5 s after rank 0, and
    both get both blobs back."""
    outs = _run_group(["late", "2"], 2)
    for rank, (out, _) in enumerate(outs):
        assert out.strip().splitlines()[-1] == f"allgather ok {rank} 2"


def test_missing_peer_fails_rendezvous():
    """A group of two whose second process never comes: the first fails
    at the rendezvous limit (2 s here) instead of waiting on."""
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [REPO] + [p for p in env.get("PYTHONPATH", "").split(os.pathsep)
                  if p])
    env.update({"SAGE_TPU_COORDINATOR": f"127.0.0.1:{_free_port()}",
                "SAGE_TPU_NUM_PROCS": "2", "SAGE_TPU_PROC_ID": "0"})
    p = subprocess.run(
        [sys.executable, os.path.abspath(__file__), "late", "2"], env=env,
        capture_output=True, text=True, timeout=SUBPROCESS_TIMEOUT_S)
    assert p.returncode != 0
    assert "allgather ok" not in p.stdout
    assert "timeout" in p.stderr.lower() or "timed out" in p.stderr.lower(), \
        p.stderr[-2000:]


@pytest.fixture(scope="module")
def three_files(tmp_path_factory):
    """A FASTA and three mzML files of MS2 and MS1 scans (those of
    tests/test_torch_lfq.py): two from one draw, the third from
    another."""
    from test_torch_lfq import _lfq_files
    from test_torch_search import _fasta

    d = tmp_path_factory.mktemp("mh_inputs")
    text = _fasta(24, 300, seed=51)
    (d / "db.fasta").write_text(text)
    a = _lfq_files(text, d, 96, 240, seed=61)
    os.makedirs(d / "b")
    b = _lfq_files(text, d / "b", 96, 240, seed=62)
    shutil.copy(b[0], d / "run2.mzML")
    return str(d / "db.fasta"), a + [str(d / "run2.mzML")]


def test_two_process_run_matches_single(three_files, tmp_path):
    """Two gloo processes over three files with quant.lfq: process 0's
    results.sage.tsv and lfq.tsv byte-equal to the port's and sage_tpu's
    1-process runs; process 1 writes nothing; both gather all three
    files' results."""
    from test_torch_runner import CONFIG, _run

    fasta, paths = three_files
    cfg = json.loads(json.dumps(CONFIG))
    cfg["database"]["fasta"] = fasta
    cfg["mzml_paths"] = paths
    cfg.update(quant={"lfq": True, "lfq_settings": {"peptide_q_value": 0.05}},
               isotope_errors=[0, 0], report_psms=1, annotate_matches=False)
    cfg_path = tmp_path / "config.json"
    cfg_path.write_text(json.dumps(cfg))
    single = {"jax": tmp_path / "jax", "port": tmp_path / "port"}
    for pkg, d in single.items():
        _run(pkg, json.loads(json.dumps(cfg)), d)
    dist_dirs = [tmp_path / f"dist{r}" for r in range(2)]
    outs = _run_group(["run", str(cfg_path), str(tmp_path / "dist")], 2)
    for rank, (out, err) in enumerate(outs):
        assert f"worker {rank} of 2 done" in out, out
        assert "gathered 3 files' results from 2 processes" in err, err[-2000:]
    assert os.listdir(dist_dirs[1]) == []
    for name in ("results.sage.tsv", "lfq.tsv"):
        with open(dist_dirs[0] / name, "rb") as f:
            got = f.read()
        for pkg, d in single.items():
            with open(d / name, "rb") as f:
                assert f.read() == got, (name, pkg)
    rows = got.decode().splitlines()
    assert len(rows) > 10
    assert rows[0].split("\t")[-3:] == [os.path.basename(p) for p in paths]


# ---------------------------------------------------------------------------
# The worker
# ---------------------------------------------------------------------------


def _worker(argv) -> int:
    sys.path.insert(0, REPO)
    from sage_tpu_torch.parallel import multihost

    if argv[0] in ("allgather", "late"):
        if argv[0] == "late":
            import datetime
            import time

            limit = float(argv[1])
            multihost.RENDEZVOUS_TIMEOUT = datetime.timedelta(seconds=limit)
        rank, n = multihost.maybe_init_distributed()
        if argv[0] == "late" and rank == 1:
            time.sleep(2.5 * limit)
        blobs = multihost.allgather_bytes(_blob(rank))
        assert blobs == [_blob(r) for r in range(n)], [len(b) for b in blobs]
        print(f"allgather ok {rank} {n}", flush=True)
        return 0
    import logging

    from sage_tpu_torch.pipeline.input import build_search
    from sage_tpu_torch.pipeline.runner import Runner

    logging.basicConfig(level=logging.INFO)
    config_path, outdir = argv[1], argv[2]
    with open(config_path) as f:
        cfg = json.load(f)
    rank = int(os.environ.get("SAGE_TPU_PROC_ID", "0"))
    search = build_search(cfg, output_directory=f"{outdir}{rank}")
    runner = Runner(search, device="cpu")
    result = runner.run()
    print(f"worker {runner.process_id} of {runner.process_count} done: "
          f"{len(result['features'])} PSMs", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(_worker(sys.argv[1:]))
