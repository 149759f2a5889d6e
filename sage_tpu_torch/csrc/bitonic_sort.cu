// Bitonic sort and bitonic merge of i32 rows in shared memory, hand-written
// for Hopper (sm_90a).
//
// Replaces the two TPU kernels of sage_tpu/ops/pallas_sort.py:
//   * _sort_kernel (one-pass ascending bitonic sort of a row) by
//     bitonic_sort_blocks_kernel, which sorts every CB-key block of a row;
//     a row that fits one block (CB = the padded row) is sorted in one pass;
//   * _finish_kernel (the in-block tail of one merge level of the
//     hierarchical sort: strides CB/2 .. 1, the lower index keeping the
//     min) by bitonic_merge_blocks_kernel.
// The flip and cross passes between them stay elementwise torch ops in
// sage_tpu_torch/ops/pallas_sort.py, as they were XLA ops outside any
// Pallas kernel in the JAX package.
//
// Design. One CTA owns one block of CB keys (a power of two, at most 2^15:
// 128 KiB of dynamic shared memory, under the 227 KB a block can use, so
// the one-pass limit on this card is 2^15 keys where the TPU's VMEM budget
// stopped at 2^14). The CTA loads its block with coalesced reads, fills
// positions past the row's length with the pad key in shared memory (the
// caller never pads in device memory), runs the whole compare-exchange
// network in shared memory with one __syncthreads() per substage, and
// writes the block back coalesced. Each thread takes CB / 2 / blockDim
// pairs per substage. Keys are plain int32: every correct sort of them
// gives one output, so the result is bit-equal to torch.sort and to the
// plain version.
//
// What bounds it on an H100. The least work is one read and one write of
// every key (8 bytes a key at 3.35 TB/s) and n log2 n compares per row at
// the card's 32-bit integer issue rate; at the open search's rows (a few
// thousand keys) the bytes are the larger. The network does
// n/2 log2 n (log2 n + 1) / 2 compare-exchanges instead, each a few
// shared-memory accesses and integer ops, so the kernel is bound by
// shared-memory traffic and the barriers between substages, not by device
// memory: it touches device memory exactly once each way.

#include <cuda_runtime.h>

namespace {

constexpr int kMaxThreads = 1024;

__device__ __forceinline__ void compare_exchange(int* s, int i, int j,
                                                 bool ascending) {
    // i has bit j clear; its partner is i + j
    const int a = s[i];
    const int b = s[i + j];
    const int lo = min(a, b);
    const int hi = max(a, b);
    s[i] = ascending ? lo : hi;
    s[i + j] = ascending ? hi : lo;
}

// One substage of the network over n keys: stride j inside blocks of
// size k; a block is ascending when its index (i / k) is even.
__device__ __forceinline__ void substage(int* s, int n, int k, int j) {
    for (int t = threadIdx.x; t < (n >> 1); t += blockDim.x) {
        const int i = ((t & ~(j - 1)) << 1) | (t & (j - 1));
        compare_exchange(s, i, j, (i & k) == 0);
    }
    __syncthreads();
}

__global__ void __launch_bounds__(kMaxThreads)
bitonic_sort_blocks_kernel(const int* __restrict__ in, int* __restrict__ out,
                           int F, int Fout, int CB, int nblk, int pad) {
    extern __shared__ int s[];
    const long long row = blockIdx.x / nblk;
    const int base = (blockIdx.x % nblk) * CB;
    const int* src = in + row * F;
    for (int i = threadIdx.x; i < CB; i += blockDim.x) {
        const int g = base + i;
        s[i] = g < F ? src[g] : pad;
    }
    __syncthreads();
    for (int k = 2; k <= CB; k <<= 1) {
        for (int j = k >> 1; j > 0; j >>= 1) substage(s, CB, k, j);
    }
    int* dst = out + row * Fout;
    for (int i = threadIdx.x; i < CB; i += blockDim.x) {
        const int g = base + i;
        if (g < Fout) dst[g] = s[i];
    }
}

__global__ void __launch_bounds__(kMaxThreads)
bitonic_merge_blocks_kernel(const int* __restrict__ in, int* __restrict__ out,
                            int CB) {
    extern __shared__ int s[];
    const long long off = (long long)blockIdx.x * CB;
    for (int i = threadIdx.x; i < CB; i += blockDim.x) s[i] = in[off + i];
    __syncthreads();
    // k = 2 CB makes every pair ascending: the uniform direction of a merge
    for (int j = CB >> 1; j > 0; j >>= 1) substage(s, CB, CB << 1, j);
    for (int i = threadIdx.x; i < CB; i += blockDim.x) out[off + i] = s[i];
}

int threads_for(int CB) {
    const int t = CB >> 1;
    return t < 32 ? 32 : (t > kMaxThreads ? kMaxThreads : t);
}

template <typename Kernel>
int set_smem(Kernel kernel, long long smem) {
    if (smem <= 48 * 1024) return 0;
    return (int)cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

}  // namespace

extern "C" {

// Sorts each CB-key block of each row ascending. Row r of `in` holds F
// keys (row stride F); block b covers padded positions [b CB, (b+1) CB),
// positions >= F read `pad`. Writes positions < Fout of each row of `out`
// (row stride Fout). CB is a power of two in [2, 2^15]; nblk CB >= Fout.
// Returns cudaGetLastError() after the launch (0 on success).
int bitonic_sort_blocks(const void* in, void* out, int rows, int F, int Fout,
                        int CB, int nblk, int pad, void* stream) {
    if (rows <= 0 || nblk <= 0) return 0;
    const long long smem = 4LL * CB;
    const int e = set_smem(bitonic_sort_blocks_kernel, smem);
    if (e != 0) return e;
    bitonic_sort_blocks_kernel<<<rows * nblk, threads_for(CB), (size_t)smem,
                                 (cudaStream_t)stream>>>(
        (const int*)in, (int*)out, F, Fout, CB, nblk, pad);
    return (int)cudaGetLastError();
}

// Ascending bitonic merge of each contiguous CB-key block of `in` (each
// block must be bitonic) into `out`; `nblocks` blocks.
int bitonic_merge_blocks(const void* in, void* out, int nblocks, int CB,
                         void* stream) {
    if (nblocks <= 0) return 0;
    const long long smem = 4LL * CB;
    const int e = set_smem(bitonic_merge_blocks_kernel, smem);
    if (e != 0) return e;
    bitonic_merge_blocks_kernel<<<nblocks, threads_for(CB), (size_t)smem,
                                  (cudaStream_t)stream>>>(
        (const int*)in, (int*)out, CB);
    return (int)cudaGetLastError();
}

}  // extern "C"
