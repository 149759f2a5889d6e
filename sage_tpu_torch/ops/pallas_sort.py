"""Row sort of i32 keys: the CUDA kernels' wrappers and their plain
PyTorch versions.

Counterpart of ``sage_tpu/ops/pallas_sort.py``, whose Pallas kernels
``_sort_kernel`` and ``_finish_kernel`` this replaces: the radix sort of
``csrc/row_sort.cu`` and the bitonic merge of ``csrc/bitonic_merge.cu``.
The open search's count core sorts each (spectrum, band) row of packed
(peptide, charge) keys with :func:`bitonic_sort_rows` (the JAX package's
name).

A row of up to ``_BLOCK_MAX`` keys is sorted in one pass of the radix
kernel (:func:`sort_blocks` with one F-key block a row), exactly its F
keys, one CTA per row. Longer rows take the hierarchical path: the row
padded to a power of two, its CB-key blocks sorted by the same kernel
(which reads the padding without storing it), then per merge level one flip
pass and the cross-block strides >= CB as torch elementwise ops, and the
merge kernel for the strides < CB. The plain versions follow the
kernels' algorithms with torch ops (LSD radix passes of 8-bit digits
with a stable counting scatter; the merge network), so the CPU tests
exercise the sign flip, the digit passes, the padding and the flip/cross
logic; on i32 keys every correct sort gives one output, so kernels,
plain versions and ``torch.sort`` agree bit for bit.

A CUDA tensor goes to the kernels, a CPU tensor to the plain versions.
``launches`` counts each kernel's launches.
"""

from __future__ import annotations

import ctypes

import torch

INT32_MAX = 2**31 - 1
# One-pass limit, and the block size of the hierarchical path: the radix
# kernel's exchange buffer for 2^15 keys is 128 KiB of shared memory,
# under the 227 KB a block can use (the TPU's VMEM budget stopped at
# 2^14).
_BLOCK_MAX = 1 << 15
# the longest row the open search sorts through these kernels
MAX_F = 1 << 17
# the radix kernel's digits: 4 passes of 8 bits over the flipped keys
_DIGIT_BITS = 8
_PASSES = 32 // _DIGIT_BITS

launches = {"row_sort": 0, "bitonic_merge": 0}


def _next_pow2(n: int) -> int:
    return 1 << max(int(n) - 1, 0).bit_length()


def _bind(name: str):
    from ._cuda_build import load

    lib = load(name)
    c_int, c_ptr = ctypes.c_int, ctypes.c_void_p
    if name == "row_sort" and lib.row_sort.argtypes is None:
        lib.row_sort.argtypes = [c_ptr, c_ptr] + [c_int] * 6 + [c_ptr]
        lib.row_sort.restype = c_int
    if name == "bitonic_merge" and lib.bitonic_merge_blocks.argtypes is None:
        lib.bitonic_merge_blocks.argtypes = [c_ptr, c_ptr, c_int, c_int, c_ptr]
        lib.bitonic_merge_blocks.restype = c_int
    return lib


def _check(x: torch.Tensor, name: str, cb: int):
    checks = (
        (x.device.type == "cuda", f"unsupported device {x.device}"),
        (x.dtype == torch.int32, "keys must be int32"),
        (x.dim() == 2 and x.is_contiguous(), "keys must be a contiguous [B, F]"),
        (1 <= cb <= _BLOCK_MAX, f"block {cb} must be in [1, {_BLOCK_MAX}]"),
    )
    for ok, msg in checks:
        if not ok:
            raise ValueError(f"{name}: {msg}")


def _raise_if(rc: int, name: str):
    if rc != 0:
        raise RuntimeError(f"{name} launch failed: CUDA error {rc}")


def sort_blocks(x: torch.Tensor, cb: int, Fout: int, pad: int):
    """Sort each ``cb``-key block of each row of i32 ``x`` [B, F]
    ascending, positions past F reading ``pad``; returns [B, Fout] (the
    first Fout positions of the padded rows). ``cb = Fout = F`` sorts
    each row in one pass."""
    if x.device.type == "cpu":
        return sort_blocks_plain(x, cb, Fout, pad)
    _check(x, "row_sort", cb)
    B, F = x.shape
    nblk = -(-max(F, Fout) // cb)
    out = torch.empty((B, Fout), dtype=torch.int32, device=x.device)
    lib = _bind("row_sort")
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.row_sort(x.data_ptr(), out.data_ptr(), B, F, Fout, cb, nblk,
                          int(pad), stream)
    _raise_if(rc, "row_sort")
    launches["row_sort"] += 1
    return out


def merge_blocks(x: torch.Tensor, cb: int):
    """Ascending bitonic merge of each contiguous ``cb``-key block of i32
    ``x`` [B, Fp] (every block bitonic, ``cb`` a power of two)."""
    if x.device.type == "cpu":
        return merge_blocks_plain(x, cb)
    _check(x, "bitonic_merge", cb)
    if cb & (cb - 1):
        raise ValueError(f"bitonic_merge: block {cb} must be a power of two")
    out = torch.empty_like(x)
    lib = _bind("bitonic_merge")
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.bitonic_merge_blocks(x.data_ptr(), out.data_ptr(),
                                      x.numel() // cb, cb, stream)
    _raise_if(rc, "bitonic_merge")
    launches["bitonic_merge"] += 1
    return out


def sort_rows_plain(x: torch.Tensor) -> torch.Tensor:
    """The radix kernel's algorithm over whole rows in torch ops, the
    plain version of a one-pass :func:`sort_blocks`: the sign bit flipped
    (i32 order becomes the order of [0, 2^32)), then LSD passes of 8-bit
    digits, each a stable scatter by the digit. The kernel leaves
    INT32_MAX out of its passes (it puts those keys last) and skips a
    pass whose digit is constant over a block's other keys; here every
    key takes part, and a pass is skipped when its digit is constant over
    each row. The kernel ranks a digit's 256 values at once (warp
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


def _merge_network(v: torch.Tensor) -> torch.Tensor:
    """The merge kernel's network over the rows of ``v`` [N, n] (n a
    power of two, each row bitonic): strides n/2 .. 1, every pair
    ascending."""
    N, n = v.shape
    d = n // 2
    while d >= 1:
        w = v.view(N, n // (2 * d), 2, d)
        v = torch.stack([torch.minimum(w[:, :, 0], w[:, :, 1]),
                         torch.maximum(w[:, :, 0], w[:, :, 1])],
                        dim=2).reshape(N, n)
        d //= 2
    return v


def sort_blocks_plain(x, cb: int, Fout: int, pad: int):
    """The plain PyTorch version of :func:`sort_blocks`."""
    B, F = x.shape
    nblk = -(-max(F, Fout) // cb)
    xp = torch.full((B, nblk * cb), int(pad), dtype=torch.int32,
                    device=x.device)
    xp[:, :F] = x
    return sort_rows_plain(xp.view(B * nblk, cb)).view(B, nblk * cb)[
        :, :Fout].contiguous()


def merge_blocks_plain(x, cb: int):
    """The plain PyTorch version of :func:`merge_blocks`."""
    return _merge_network(x.reshape(-1, cb)).view(x.shape)


def _hier_sort(x, F: int, Fp: int, cb: int, pad: int):
    """Rows longer than one block: sort the cb-key blocks, then per merge
    level one flip pass (each ascending run against the mirror image of
    its sibling: the first substage of merging two ascending runs), the
    cross-block substages at strides >= cb (paired min/max), and the merge
    kernel for the strides < cb."""
    B = x.shape[0]
    x = sort_blocks(x, cb, Fp, pad)
    n = 2 * cb
    while n <= Fp:
        xr = x.view(B, Fp // n, n)
        a = xr[..., : n // 2]
        b = xr[..., n // 2:].flip(-1)
        x = torch.cat(
            [torch.minimum(a, b), torch.maximum(a, b).flip(-1)], dim=-1
        ).reshape(B, Fp)
        d = n // 4
        while d >= cb:
            xr = x.view(B, -1, 2, d)
            x = torch.stack(
                [torch.minimum(xr[..., 0, :], xr[..., 1, :]),
                 torch.maximum(xr[..., 0, :], xr[..., 1, :])], dim=-2
            ).reshape(B, Fp)
            d //= 2
        x = merge_blocks(x, cb)
        n *= 2
    return x[:, :F].contiguous()


def bitonic_sort_rows(x: torch.Tensor, pad_value: int = INT32_MAX,
                      block=None) -> torch.Tensor:
    """Sort each row of i32 ``x`` [B, F] ascending; the result is [B, F].
    A row of up to ``_BLOCK_MAX`` keys is sorted in one pass; a longer
    row takes the hierarchical path, padded to a power of two with
    ``pad_value`` (which must be >= every real key, so the padding lands
    past F). ``block`` forces the hierarchical path's block size (a
    testing hook, as in the JAX package)."""
    B, F = x.shape
    if B == 0 or F == 0:
        return x.clone()
    x = x.contiguous()
    Fp = _next_pow2(F)
    cb = min(block or _BLOCK_MAX, _BLOCK_MAX)
    if Fp <= cb:
        return sort_blocks(x, F, F, pad_value)
    return _hier_sort(x, F, Fp, cb, pad_value)


def use_pallas_sort(F: int, n_pep: int) -> bool:
    """Can the open search sort rows of F keys through these kernels:
    the row is at most ``MAX_F`` keys and peptide ids fit the 25-bit
    field of the packed key."""
    return F <= MAX_F and n_pep < (1 << 25)
