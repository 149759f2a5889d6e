"""Multi-process execution: each process streams its own shard of the
input files, and the per-file results are merged before the global
rescoring / FDR stages.

Counterpart of ``sage_tpu/parallel/multihost.py``, on
``torch.distributed``. The reference is strictly single-process; its
analog of this layer is the rayon parallel reduce of per-batch
`SageResults` (crates/sage-cli/src/output.rs:21-41, driven by the batch
loop runner.rs:482-489):

* :func:`maybe_init_distributed` forms the process group when the
  environment asks for one;
* each process searches its own shard of the input files (round-robin
  by file index, keeping global file_ids) on its own card, or on a card
  it shares with other processes;
* before RT alignment / LDA / FDR, which are global and deterministic
  host stages, every process gathers all processes' FeatureTables, TMT
  quant records and MS1 spectra, re-assembles them in global file order
  and runs the same global stages. Only process 0 writes outputs.

The backend is gloo, on purpose: what travels is pickled host data
(FeatureTables, TMT quant, MS1 spectra), gathered as CPU byte tensors.
NCCL moves device tensors only, needs one card per rank and refuses two
ranks on one card; gloo runs any number of processes on one machine or
across machines, cards shared or not.

The merged result is byte-identical to a single-process run: pieces are
re-ordered by file_id before concatenation and PSM ids are re-assigned
deterministically by row order (the reference's `PSM_COUNTER` is a racy
global atomic, scoring.rs:163-166 — here determinism is kept instead).
"""

from __future__ import annotations

import datetime
import logging
import os
import pickle
from typing import List, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

log = logging.getLogger("sage_tpu_torch")

# A peer that never joins fails the rendezvous after this long instead
# of hanging the run.
RENDEZVOUS_TIMEOUT = datetime.timedelta(seconds=120)
# gloo bounds every collective of a group by the group's timeout, and the
# gather waits for the process with the slowest shard, which at real size
# can be hours behind the fastest. So the gathers go through a group of
# their own with this limit; a peer that dies closes its connections and
# fails the gather at once, so only a peer that hangs waits it out.
GATHER_TIMEOUT = datetime.timedelta(hours=24)
# the gathers' group, made with the process group; None when the group
# came from elsewhere, and then its default group serves
_gather_group = None


def maybe_init_distributed() -> Tuple[int, int]:
    """Form the gloo process group when the environment asks for one and
    return (process_id, process_count).

    Triggers, as ``sage_tpu``'s: SAGE_TPU_COORDINATOR ("host:port", with
    SAGE_TPU_NUM_PROCS and SAGE_TPU_PROC_ID) joins the group at
    ``tcp://host:port``; SAGE_TPU_DISTRIBUTED=1 joins it from the
    ``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR`` and ``MASTER_PORT`` that
    ``torchrun`` sets (``env://``). The latter takes the place of JAX's
    auto-detection on TPU pods and SLURM, which torch does not have.
    Without a trigger the run is one process, (0, 1), and no group is
    made. A group that already exists is used as it is.

    The rendezvous is bounded by RENDEZVOUS_TIMEOUT, the gathers by
    GATHER_TIMEOUT."""
    global _gather_group
    if dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    coord = os.environ.get("SAGE_TPU_COORDINATOR")
    auto = os.environ.get("SAGE_TPU_DISTRIBUTED") == "1"
    if not coord and not auto:
        return 0, 1
    if coord:
        dist.init_process_group(
            "gloo", init_method=f"tcp://{coord}",
            world_size=int(os.environ["SAGE_TPU_NUM_PROCS"]),
            rank=int(os.environ["SAGE_TPU_PROC_ID"]),
            timeout=RENDEZVOUS_TIMEOUT,
        )
    else:
        dist.init_process_group("gloo", init_method="env://",
                                timeout=RENDEZVOUS_TIMEOUT)
    _gather_group = dist.new_group(backend="gloo", timeout=GATHER_TIMEOUT)
    log.info("distributed: process %d of %d (gloo)", dist.get_rank(),
             dist.get_world_size())
    return dist.get_rank(), dist.get_world_size()


def shard_paths(
    paths: Sequence[str], process_id: int, process_count: int
) -> List[Tuple[int, str]]:
    """This process's shard of the input files, round-robin by index so
    all processes get similar load; file_ids stay GLOBAL (they key
    spec_ids, RT alignment's per-file regressions, and the output
    filename column)."""
    return [
        (fid, p)
        for fid, p in enumerate(paths)
        if fid % process_count == process_id
    ]


def allgather_bytes(data: bytes) -> List[bytes]:
    """All-gather one opaque byte blob per process (padded uint8 CPU
    tensors over gloo, bounded by GATHER_TIMEOUT). Returns the
    per-process blobs in process-id order on every process."""
    n = _process_count()
    if n == 1:
        return [data]
    lens_t = [torch.zeros(1, dtype=torch.int64) for _ in range(n)]
    dist.all_gather(lens_t, torch.tensor([len(data)], dtype=torch.int64),
                    group=_gather_group)
    lens = [int(t[0]) for t in lens_t]
    mx = max(max(lens), 1)
    # Gather in bounded chunks: peak footprint is n_procs x CHUNK rather
    # than n_procs x max_blob (result blobs can reach hundreds of MB on
    # real multi-file runs).
    chunk = int(os.environ.get("SAGE_TPU_ALLGATHER_CHUNK_MB", "64")) << 20
    chunk = max(chunk, 1 << 20)
    src = np.frombuffer(data, np.uint8)
    parts: List[List[np.ndarray]] = [[] for _ in range(n)]
    for off in range(0, mx, chunk):
        c = min(chunk, mx - off)
        buf = np.zeros(c, np.uint8)
        have = max(min(len(data) - off, c), 0)
        if have:
            buf[:have] = src[off : off + have]
        bufs = [torch.empty(c, dtype=torch.uint8) for _ in range(n)]
        dist.all_gather(bufs, torch.from_numpy(buf), group=_gather_group)
        for i in range(n):
            take = max(min(lens[i] - off, c), 0)
            if take:
                # copy: a VIEW would pin the whole chunk buffer until the
                # final join, re-growing the footprint the chunking
                # exists to bound
                parts[i].append(bufs[i].numpy()[:take].copy())
    return [
        b"".join(p.tobytes() for p in parts[i]) if parts[i] else b""
        for i in range(n)
    ]


def _process_count() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def gather_file_results(
    pieces: List[Tuple[int, object, list, list]],
) -> List[Tuple[int, object, list, list]]:
    """All-gather the per-file search results — (file_id, FeatureTable,
    tmt_quant, ms1_spectra) tuples — across processes, returning the
    union sorted by file_id on every process. The cross-process analog of
    the reference's SageResults reduce (output.rs:21-41)."""
    blob = pickle.dumps(pieces, protocol=pickle.HIGHEST_PROTOCOL)
    blobs = allgather_bytes(blob)
    merged: List[Tuple[int, object, list, list]] = []
    for b in blobs:
        merged.extend(pickle.loads(b))
    merged.sort(key=lambda t: t[0])
    return merged
