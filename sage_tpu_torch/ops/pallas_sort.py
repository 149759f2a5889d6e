"""Bitonic sort of i32 rows: the CUDA kernels' wrappers and their plain
PyTorch versions.

Counterpart of ``sage_tpu/ops/pallas_sort.py``, whose Pallas kernels
``_sort_kernel`` and ``_finish_kernel`` this replaces
(``csrc/bitonic_sort.cu``). The open search's count core sorts each
(spectrum, band) row of packed (peptide, charge) keys with
:func:`bitonic_sort_rows`.

A row of up to ``_BLOCK_MAX`` keys (padded to a power of two) is sorted
in one pass, one CTA per row in shared memory. Longer rows take the
hierarchical path: CB-key blocks sorted by the same kernel, then per
merge level one flip pass and the cross-block strides >= CB as torch
elementwise ops, and the merge kernel for the strides < CB. The plain
versions run the same network with torch ops, so the CPU tests exercise
the directions, the padding and the flip/cross logic that the kernels
implement; on i32 keys every correct sort gives one output, so kernel,
plain version and ``torch.sort`` agree bit for bit.

A CUDA tensor goes to the kernels, a CPU tensor to the plain versions.
``launches`` counts each kernel's launches.
"""

from __future__ import annotations

import ctypes

import torch

INT32_MAX = 2**31 - 1
# One-pass limit, and the block size of the hierarchical path: a row of
# 2^15 keys is 128 KiB of shared memory, under the 227 KB a block can use
# (the TPU's VMEM budget stopped at 2^14).
_BLOCK_MAX = 1 << 15
# the longest row the open search sorts through these kernels
MAX_F = 1 << 17

launches = {"bitonic_sort": 0, "bitonic_merge": 0}


def _next_pow2(n: int) -> int:
    return 1 << max(int(n) - 1, 0).bit_length()


def _bind():
    from ._cuda_build import load

    lib = load("bitonic_sort")
    if lib.bitonic_sort_blocks.argtypes is None:
        c_int, c_ptr = ctypes.c_int, ctypes.c_void_p
        lib.bitonic_sort_blocks.argtypes = [c_ptr, c_ptr] + [c_int] * 6 + [c_ptr]
        lib.bitonic_sort_blocks.restype = c_int
        lib.bitonic_merge_blocks.argtypes = [c_ptr, c_ptr, c_int, c_int, c_ptr]
        lib.bitonic_merge_blocks.restype = c_int
    return lib


def _check(x: torch.Tensor, name: str, cb: int):
    checks = (
        (x.device.type == "cuda", f"unsupported device {x.device}"),
        (x.dtype == torch.int32, "keys must be int32"),
        (x.dim() == 2 and x.is_contiguous(), "keys must be a contiguous [B, F]"),
        (2 <= cb <= _BLOCK_MAX and cb & (cb - 1) == 0,
         f"block {cb} must be a power of two in [2, {_BLOCK_MAX}]"),
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
    first Fout positions of the padded rows). One block per row when
    ``cb`` covers the padded row."""
    if x.device.type == "cpu":
        return sort_blocks_plain(x, cb, Fout, pad)
    _check(x, "bitonic_sort", max(cb, 2))
    B, F = x.shape
    nblk = -(-max(F, Fout) // cb)
    out = torch.empty((B, Fout), dtype=torch.int32, device=x.device)
    lib = _bind()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.bitonic_sort_blocks(x.data_ptr(), out.data_ptr(), B, F, Fout,
                                     cb, nblk, int(pad), stream)
    _raise_if(rc, "bitonic_sort")
    launches["bitonic_sort"] += 1
    return out


def merge_blocks(x: torch.Tensor, cb: int):
    """Ascending bitonic merge of each contiguous ``cb``-key block of i32
    ``x`` [B, Fp] (every block bitonic)."""
    if x.device.type == "cpu":
        return merge_blocks_plain(x, cb)
    _check(x, "bitonic_merge", cb)
    out = torch.empty_like(x)
    lib = _bind()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.bitonic_merge_blocks(x.data_ptr(), out.data_ptr(),
                                      x.numel() // cb, cb, stream)
    _raise_if(rc, "bitonic_merge")
    launches["bitonic_merge"] += 1
    return out


def _network(v: torch.Tensor, merge_only: bool) -> torch.Tensor:
    """The kernels' compare-exchange network over the rows of ``v``
    [N, n] (n a power of two): the full sort (stages of size 2, 4, .., n,
    a block ascending when its index is even), or with ``merge_only`` the
    last stage alone (every pair ascending)."""
    N, n = v.shape
    k = n.bit_length() - 1
    for s in ([k] if merge_only else range(1, k + 1)):
        size = 1 << s
        asc = (torch.arange(n // size, device=v.device) % 2 == 0).view(
            1, -1, 1, 1)
        for j in range(s - 1, -1, -1):
            d = 1 << j
            w = v.view(N, n // size, size // (2 * d), 2, d)
            lo = torch.minimum(w[..., 0, :], w[..., 1, :])
            hi = torch.maximum(w[..., 0, :], w[..., 1, :])
            v = torch.stack(
                [torch.where(asc, lo, hi), torch.where(asc, hi, lo)], dim=3
            ).reshape(N, n)
    return v


def sort_blocks_plain(x, cb: int, Fout: int, pad: int):
    """The plain PyTorch version of :func:`sort_blocks`."""
    B, F = x.shape
    nblk = -(-max(F, Fout) // cb)
    xp = torch.full((B, nblk * cb), int(pad), dtype=torch.int32,
                    device=x.device)
    xp[:, :F] = x
    return _network(xp.view(B * nblk, cb), False).view(B, nblk * cb)[
        :, :Fout].contiguous()


def merge_blocks_plain(x, cb: int):
    """The plain PyTorch version of :func:`merge_blocks`."""
    return _network(x.reshape(-1, cb), True).view(x.shape)


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
    """Sort each row of i32 ``x`` [B, F] ascending. Rows are padded to a
    power of two with ``pad_value`` (which must be >= every real key, so
    the padding lands past F) inside the kernels; the result is [B, F].
    ``block`` forces the hierarchical path's block size (a testing hook,
    as in the JAX package); by default a row of up to ``_BLOCK_MAX`` keys
    is sorted in one pass."""
    B, F = x.shape
    if B == 0 or F == 0:
        return x.clone()
    x = x.contiguous()
    Fp = _next_pow2(F)
    cb = min(block or _BLOCK_MAX, _BLOCK_MAX)
    if Fp <= cb:
        return sort_blocks(x, Fp, F, pad_value)
    return _hier_sort(x, F, Fp, cb, pad_value)


def use_pallas_sort(F: int, n_pep: int) -> bool:
    """Can the open search sort rows of F keys through these kernels:
    the row is at most ``MAX_F`` keys and peptide ids fit the 25-bit
    field of the packed key."""
    return F <= MAX_F and n_pep < (1 << 25)
