"""Stage-1 window counts for the narrow search: the CUDA kernel's wrapper
and its plain PyTorch version.

Counterpart of ``sage_tpu/ops/pallas_stage1.py`` (whose Pallas kernel
``_kernel`` this replaces). For each query row (spectrum x precursor
charge x isotope error) and each candidate of its W-wide window of the
mass-sorted ladder table, the count of in-tolerance (peak x fragment
charge x fragment) pairs, ``#(f >= lo_z) - #(f > hi_z)``; candidates
outside the row's peptide range [i0, i1) count 0. Output: i32
``[R, W + 2]`` = ``[counts[0..W), sum(counts), #(counts > 0)]``.

A CUDA tensor goes to the kernel (``csrc/stage1_counts.cu``), a CPU
tensor to the plain version. ``launches`` counts kernel launches, as
does the recorder's ``launch.stage1_counts`` counter (``utils/trace.py``).
"""

from __future__ import annotations

import ctypes

import torch

from ..utils import trace

launches = 0

_TOL_KIND = {"ppm": 0, "pct": 1, "da": 2}
# elements of the [rows, S, W, Lc, Pk] compare grid per plain-version chunk
_PLAIN_CHUNK = 1 << 24
# The kernel's tiles, mirrored from csrc/stage1_counts.cu: fragments a
# fragment tile, and peaks a tile of bounds
_TILE = 256 * 8
_PEAK_TILE = 1024
_SMEM_MAX = 227 * 1024


def stage1_counts_smem_bytes(W: int, Pk: int, Z: int) -> int:
    """Dynamic shared memory the kernel needs, in bytes (the mirror of
    ``csrc/stage1_counts.cu:stage1_counts_smem_bytes``): one peak tile's
    Z planes of low and high bounds (a tile holds up to 1024 peaks, so
    past that Pk adds nothing), the two fragment buffers and the W
    candidate counts."""
    tq = (min(Pk, _PEAK_TILE) + 3) // 4
    return 32 * Z * tq + 8 * _TILE + 4 * W


def _bind():
    from ._cuda_build import load

    lib = load("stage1_counts")
    fn = lib.stage1_counts
    if fn.argtypes is None:
        c_int, c_ptr = ctypes.c_int, ctypes.c_void_p
        fn.argtypes = (
            [c_ptr] * 4 + [c_int] * 10 + [ctypes.c_float] * 2 + [c_ptr]
        )
        fn.restype = c_int
        lib.stage1_counts_smem_bytes.argtypes = [c_int] * 3
        lib.stage1_counts_smem_bytes.restype = ctypes.c_longlong
    return lib


def stage1_counts(lad_index, peaks, ints, *, W: int, Lc: int, Z: int, tol):
    """Counts-only stage 1 for one segment.

    lad_index: f32 [P_pad, S, L] index ladders (-inf in invalid slots);
    peaks: f32 [B, Pk] neutral peak masses (+inf pads); ints: i32 [5, R]
    rows (spectrum, p0, i0, i1, maxz); W: window width; Lc <= L: ladder
    slots read per series; Z: fragment-charge planes; tol: (kind, lo, hi)
    fragment tolerance. Returns i32 [R, W + 2]."""
    global launches
    if lad_index.device.type == "cpu":
        return stage1_counts_plain(
            lad_index, peaks, ints, W=W, Lc=Lc, Z=Z, tol=tol
        )
    if lad_index.device.type != "cuda":
        raise ValueError(f"stage1_counts: unsupported device {lad_index.device}")
    P_pad, S, L = lad_index.shape
    B, Pk = peaks.shape
    R = ints.shape[1]
    kind, tlo, thi = tol
    checks = (
        (lad_index.dtype == torch.float32 and peaks.dtype == torch.float32
         and ints.dtype == torch.int32, "dtypes must be f32, f32, i32"),
        (peaks.device == lad_index.device and ints.device == lad_index.device,
         "tensors must share one device"),
        (lad_index.is_contiguous() and peaks.is_contiguous()
         and ints.is_contiguous(), "tensors must be contiguous"),
        (ints.dim() == 2 and ints.shape[0] == 5, "ints must be [5, R]"),
        (0 < W <= P_pad and 0 < Lc <= L and Z >= 1 and B >= 1 and Pk >= 1,
         f"bad shapes W={W} Lc={Lc} Z={Z} B={B} Pk={Pk} P_pad={P_pad} L={L}"),
        (kind in _TOL_KIND, f"tolerance kind {kind!r}"),
    )
    for ok, msg in checks:
        if not ok:
            raise ValueError(f"stage1_counts: {msg}")
    smem = stage1_counts_smem_bytes(W, Pk, Z)
    if smem > _SMEM_MAX:
        raise ValueError(
            f"stage1_counts: {smem} B of shared memory (W={W}, Z={Z}) "
            f"exceeds the 227 KB a block can use"
        )
    lib = _bind()
    out = torch.empty((R, W + 2), dtype=torch.int32, device=lad_index.device)
    with torch.cuda.device(lad_index.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.stage1_counts(
            lad_index.data_ptr(), peaks.data_ptr(), ints.data_ptr(),
            out.data_ptr(), R, P_pad, S, L, Lc, B, Pk, W, Z, _TOL_KIND[kind],
            float(tlo), float(thi), stream,
        )
    if rc != 0:
        raise RuntimeError(f"stage1_counts launch failed: CUDA error {rc}")
    launches += 1
    trace.count("launch.stage1_counts")
    return out


def stage1_counts_plain(lad_index, peaks, ints, *, W: int, Lc: int, Z: int,
                        tol):
    """The plain PyTorch version of :func:`stage1_counts`: the same
    function, computed with ``count_fragment_matches`` over row chunks."""
    from .search import count_fragment_matches

    P_pad, S, L = lad_index.shape
    B, Pk = peaks.shape
    R = ints.shape[1]
    dev = lad_index.device
    kind, tlo, thi = tol
    spec = ints[0].long().clamp(0, B - 1)
    p0 = ints[1].long().clamp(0, P_pad - W)
    i0, i1, maxz = ints[2].long(), ints[3].long(), ints[4]
    out = torch.empty((R, W + 2), dtype=torch.int32, device=dev)
    step = max(1, _PLAIN_CHUNK // max(S * W * Lc * Pk, 1))
    w_ar = torch.arange(W, device=dev)
    for a in range(0, R, step):
        b = min(a + step, R)
        gidx = p0[a:b, None] + w_ar[None, :]                 # [r, W]
        f = lad_index[gidx][..., :Lc].permute(0, 2, 1, 3)    # [r, S, W, Lc]
        counts = count_fragment_matches(
            f, peaks[spec[a:b]], (kind, tlo, thi), maxz[a:b], Z
        )
        valid = (gidx >= i0[a:b, None]) & (gidx < i1[a:b, None])
        counts = torch.where(valid, counts, 0)
        out[a:b, :W] = counts
        out[a:b, W] = counts.sum(dim=1, dtype=torch.int32)
        out[a:b, W + 1] = (counts > 0).sum(dim=1, dtype=torch.int32)
    return out
