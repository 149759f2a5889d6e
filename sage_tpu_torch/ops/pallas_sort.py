"""Row sort of i32 keys: the CUDA kernels' wrappers and their plain
PyTorch versions.

Counterpart of ``sage_tpu/ops/pallas_sort.py``, whose Pallas kernels
``_sort_kernel`` and ``_finish_kernel`` this replaces: the radix sort of
``csrc/row_sort.cu`` and the cluster radix sort of
``csrc/cluster_sort.cu``. The open search's count core sorts each
(spectrum, band) row of packed (peptide, charge) keys with
:func:`bitonic_sort_rows` (the JAX package's name).

A row of up to ``_BLOCK_MAX`` keys is sorted in one pass of the radix
kernel (:func:`sort_rows`), exactly its F keys, one CTA per row. A
longer row is sorted by :func:`cluster_sort`, one thread-block cluster
of up to 8 CTAs a row, in one launch: where the JAX package sorted a
long row in blocks and merged them over several passes through device
memory, the cluster holds the whole row in its CTAs' shared memory. The plain versions follow the kernels' algorithms
with torch ops (LSD radix passes with stable counting scatters; the
cluster's slices, real-key count, varying bits, cross-slice offsets and
INT32_MAX tail), so the CPU tests exercise the sign flip, the digit
passes, the slices and the tail; on i32 keys every correct sort gives
one output, so kernels, plain versions and ``torch.sort`` agree bit for
bit.

A CUDA tensor goes to the kernels, a CPU tensor to the plain versions.
``launches`` counts each kernel's launches, as do the recorder's
``launch.<kernel>`` counters (``utils/trace.py``).
"""

from __future__ import annotations

import ctypes

import torch

from ..utils import trace

INT32_MAX = 2**31 - 1
# One-pass limit of the radix kernel: its exchange buffer for 2^15 keys
# is 128 KiB of shared memory, under the 227 KB a block can use (the
# TPU's VMEM budget stopped at 2^14).
_BLOCK_MAX = 1 << 15
# the longest row the open search sorts through these kernels
MAX_F = 1 << 17
# the row-sort kernel's digits: 4 passes of 8 bits over the flipped keys
_DIGIT_BITS = 8
_PASSES = 32 // _DIGIT_BITS
# The cluster kernel: 9-bit digits; at most 8 CTAs a row (the portable
# cluster size); a CTA takes a slice of at most 2^14 keys (its buffers
# and histograms fill 160 KiB of shared memory; a row of MAX_F keys takes
# 8 CTAs, and 2^16 keys in 4 CTAs measured faster than in 5 or 8 on an
# H100); the row is dealt to the CTAs in chunks of at most 256 keys.
_CLUSTER_BITS = 9
_CLUSTER_MAX = 8
_SLICE = 1 << 14
_CHUNK = 256

launches = {"row_sort": 0, "cluster_sort": 0}


def _bind(name: str):
    from ._cuda_build import load

    lib = load(name)
    c_int, c_ptr = ctypes.c_int, ctypes.c_void_p
    if name == "row_sort" and lib.row_sort.argtypes is None:
        lib.row_sort.argtypes = [c_ptr, c_ptr, c_int, c_int, c_ptr]
        lib.row_sort.restype = c_int
    if name == "cluster_sort" and lib.cluster_sort.argtypes is None:
        lib.cluster_sort.argtypes = [c_ptr, c_ptr] + [c_int] * 4 + [c_ptr]
        lib.cluster_sort.restype = c_int
        lib.cluster_sort_occupancy.argtypes = [c_int] * 4 + [c_ptr] * 2
        lib.cluster_sort_occupancy.restype = c_int
    return lib


def _check(x: torch.Tensor, name: str, *more):
    checks = (
        (x.device.type == "cuda", f"unsupported device {x.device}"),
        (x.dtype == torch.int32, "keys must be int32"),
        (x.dim() == 2 and x.is_contiguous(), "keys must be a contiguous [B, F]"),
    ) + more
    for ok, msg in checks:
        if not ok:
            raise ValueError(f"{name}: {msg}")


def _raise_if(rc: int, name: str):
    if rc != 0:
        raise RuntimeError(f"{name} launch failed: CUDA error {rc}")


def sort_rows(x: torch.Tensor) -> torch.Tensor:
    """Sort each row of i32 ``x`` [B, F], F <= ``_BLOCK_MAX``, ascending
    in one launch of the radix kernel, one CTA a row."""
    if x.device.type == "cpu":
        return sort_rows_plain(x)
    B, F = x.shape
    _check(x, "row_sort", (F <= _BLOCK_MAX,
                           f"rows of {F} keys: at most {_BLOCK_MAX}"))
    out = torch.empty_like(x)
    lib = _bind("row_sort")
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.row_sort(x.data_ptr(), out.data_ptr(), B, F, stream)
    _raise_if(rc, "row_sort")
    launches["row_sort"] += 1
    trace.count("launch.row_sort")
    return out


def sort_rows_plain(x: torch.Tensor) -> torch.Tensor:
    """The radix kernel's algorithm over whole rows in torch ops, the
    plain version of :func:`sort_rows`: the sign bit flipped
    (i32 order becomes the order of [0, 2^32)), then LSD passes of 8-bit
    digits, each a stable scatter by the digit. The kernel leaves
    INT32_MAX out of its passes (it puts those keys last) and skips a
    pass whose digit is constant over a block's other keys; here every
    key takes part, and a pass is skipped when its digit is constant over
    every row. The kernel ranks a digit's 256 values at once (warp
    histograms and a scan); here each pass is eight stable counting
    scatters by one bit, least significant first, which compose to the
    same stable scatter by the digit: a key with bit 0 goes to the count
    of 0 bits before it, a key with bit 1 after every 0 bit of its row."""
    N, F = x.shape
    v = x.to(torch.int64) + 2**31
    pos = torch.arange(F, device=x.device)
    for p in range(_PASSES):
        shift = _DIGIT_BITS * p
        d = (v >> shift) & ((1 << _DIGIT_BITS) - 1)
        if F == 0 or bool((d.amin(1) >= d.amax(1)).all()):
            continue
        for b in range(shift, shift + _DIGIT_BITS):
            bit = (v >> b) & 1
            ones = bit.cumsum(1)
            zeros = F - ones[:, -1:]
            dst = torch.where(bit == 1, zeros + ones - 1, pos - ones)
            v = torch.empty_like(v).scatter_(1, dst, v)
    return (v - 2**31).to(torch.int32)


def cluster_shape(F: int, block=None):
    """The cluster kernel's shape for rows of F keys: (C, G, cap), C CTAs
    a row, each taking a slice of about F / C keys dealt to it in chunks
    of G keys, and the keys a CTA's buffer holds (its chunks' count
    rounded up, times G). By default a slice is ``_SLICE`` keys (so C is
    at most ``_CLUSTER_MAX`` for rows up to MAX_F); ``block`` forces the
    slice size (and so C)."""
    C = -(-F // (block or _SLICE))
    G = min(_CHUNK, -(-F // C))
    return C, G, -(-(-(-F // G)) // C) * G


def cluster_sort(x: torch.Tensor, block=None) -> torch.Tensor:
    """Sort each row of i32 ``x`` [B, F] ascending in one launch of the
    cluster kernel, one cluster of C <= 8 CTAs a row (see
    :func:`cluster_shape`; ``block`` forces the slice size, and on the
    card a ``block`` that needs more than 8 slices, or a slice past
    ``_SLICE`` keys, is refused)."""
    if x.device.type == "cpu":
        return cluster_sort_plain(x, block)
    B, F = x.shape
    C, G, cap = cluster_shape(F, block)
    _check(x, "cluster_sort",
           (C <= _CLUSTER_MAX, f"{C} slices of {block} keys: at most "
            f"{_CLUSTER_MAX} CTAs a cluster"),
           (cap <= _SLICE, f"slices of {cap} keys: at most {_SLICE}"))
    out = torch.empty_like(x)
    lib = _bind("cluster_sort")
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.cluster_sort(x.data_ptr(), out.data_ptr(), B, F, C, G,
                              stream)
    _raise_if(rc, "cluster_sort")
    launches["cluster_sort"] += 1
    trace.count("launch.cluster_sort")
    return out


def cluster_occupancy(B: int, F: int, block=None):
    """``cudaOccupancyMaxActiveClusters`` for :func:`cluster_sort` of
    [B, F] rows on the current card: (C, G, active clusters, shared
    bytes a CTA)."""
    C, G, _cap = cluster_shape(F, block)
    n, smem = ctypes.c_int(0), ctypes.c_int(0)
    rc = _bind("cluster_sort").cluster_sort_occupancy(
        B, F, C, G, ctypes.byref(n), ctypes.byref(smem))
    _raise_if(rc, "cluster_sort_occupancy")
    return C, G, n.value, smem.value


def _stable_rank(key: torch.Tensor, nbits: int) -> torch.Tensor:
    """Each element's position in a stable ascending order of its row of
    ``key`` (non-negative, below 2^nbits): stable counting scatters by
    one bit, least significant first (see :func:`sort_rows_plain`)."""
    N, n = key.shape
    pos = torch.arange(n, device=key.device).expand(N, n)
    idx = pos
    for b in range(nbits):
        bit = (key >> b) & 1
        ones = bit.cumsum(1)
        zeros = n - ones[:, -1:]
        dst = torch.where(bit == 1, zeros + ones - 1, pos - ones)
        key = torch.empty_like(key).scatter_(1, dst, key)
        idx = torch.empty_like(idx).scatter_(1, dst, idx)
    return torch.empty_like(idx).scatter_(1, idx, pos)


def _cluster_pass(v, d, sl, C):
    """One digit pass of the cluster kernel over rows ``v`` [B, n] (keys
    in their current order), digits ``d`` (2^_CLUSTER_BITS for INT32_MAX,
    which go last) and slices ``sl`` (non-decreasing along each row, < C):
    each slice's histogram; each (digit, slice)'s first position,
    digit-major over the row; each key's rank among the equal digits of
    its slice before it; the scatter."""
    B, n = v.shape
    nd = (1 << _CLUSTER_BITS) + 1  # the digits, and one for INT32_MAX
    key = sl * nd + d
    cnt = torch.zeros((B, C * nd), dtype=torch.int64, device=v.device)
    cnt.scatter_add_(1, key, torch.ones_like(key))
    dm = cnt.view(B, C, nd).transpose(1, 2).reshape(B, nd * C)
    first = (dm.cumsum(1) - dm).view(B, nd, C).transpose(1, 2).reshape(
        B, C * nd)
    start = cnt.cumsum(1) - cnt  # slice-major: sl is non-decreasing
    rank = (_stable_rank(key, (C * nd - 1).bit_length())
            - start.gather(1, key))
    return torch.empty_like(v).scatter_(1, first.gather(1, key) + rank, v)


def cluster_sort_plain(x: torch.Tensor, block=None) -> torch.Tensor:
    """The cluster kernel's algorithm in torch ops, the plain version of
    :func:`cluster_sort`. The row's G-key chunks dealt to C slices in
    turn (the kernel appends each slice's real keys in no fixed order,
    since the first pass needs no stability; here in position order);
    the real (not INT32_MAX) keys counted (N a row) and the bits that vary
    over them; then LSD passes of 9-bit digits of the sign-flipped keys
    over the span of varying bits, lowest first, a digit with no varying
    bit in any row skipped, each a :func:`_cluster_pass` over the slices:
    the first over the dealt slices, the later ones over the kernel's
    layout of N / C keys a slice; a row whose N keys fit one slice's
    buffer is passed as one slice throughout (the kernel gathers them into
    its first CTA). The INT32_MAX keys take the last digit and so fill the
    tail; with no pass, each row's real keys are one value."""
    B, F = x.shape
    C, G, cap = cluster_shape(F, block)
    dev = x.device
    pos = torch.arange(F, device=dev)
    cta = (pos // G) % C
    order = torch.argsort(cta * F + pos)
    xs = x[:, order]
    ranked = xs != INT32_MAX
    v = xs.to(torch.int64) + 2**31
    N = ranked.sum(1, keepdim=True)
    S2 = torch.clamp(-(-N // C), min=1)
    one_slice = N <= cap
    sl = torch.where(one_slice, 0, cta[order].expand(B, F))
    vary = 0  # the bits that vary over some row's real keys
    for b in range(32):
        bit = ((v >> b) & 1).bool()
        if bool(((bit & ranked).any(1) & ~(bit | ~ranked).all(1)).any()):
            vary |= 1 << b
    lo = (vary & -vary).bit_length() - 1
    mask = (1 << _CLUSTER_BITS) - 1
    ran = False
    for shift in range(max(lo, 0), vary.bit_length(), _CLUSTER_BITS):
        if not (vary >> shift) & mask:
            continue
        if ran:
            sl = torch.where(one_slice, 0, torch.clamp(pos // S2, max=C - 1))
        d = torch.where(ranked, (v >> shift) & mask, mask + 1)
        v = _cluster_pass(v, d, sl, C)
        ranked = v != INT32_MAX + 2**31
        ran = True
    if not ran:
        one = torch.where(ranked, v, 0).amax(1, keepdim=True)
        v = torch.where(pos < N, one, INT32_MAX + 2**31)
    return (v - 2**31).to(torch.int32)


def bitonic_sort_rows(x: torch.Tensor, block=None) -> torch.Tensor:
    """Sort each row of i32 ``x`` [B, F] ascending; the result is [B, F].
    A row of up to ``_BLOCK_MAX`` keys is sorted in one pass of the
    radix kernel, a longer one by the cluster kernel. ``block`` (a
    testing hook, as in the JAX package) lowers the one-pass limit and
    forces the cluster kernel's slice size, so that small rows take the
    multi-slice path."""
    B, F = x.shape
    if B == 0 or F == 0:
        return x.clone()
    x = x.contiguous()
    if F <= min(block or _BLOCK_MAX, _BLOCK_MAX):
        return sort_rows(x)
    return cluster_sort(x, block)


def use_pallas_sort(F: int, n_pep: int) -> bool:
    """Can the open search sort rows of F keys through these kernels:
    the row is at most ``MAX_F`` keys and peptide ids fit the 25-bit
    field of the packed key."""
    return F <= MAX_F and n_pep < (1 << 25)
