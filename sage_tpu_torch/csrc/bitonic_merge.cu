// Bitonic merge of i32 blocks in shared memory, hand-written for Hopper
// (sm_90a).
//
// Replaces sage_tpu/ops/pallas_sort.py::_finish_kernel (the in-block tail
// of one merge level of the hierarchical sort: strides CB/2 .. 1, the
// lower index keeping the min) by bitonic_merge_blocks_kernel. The
// hierarchical path sorts a row's 2^15-key blocks with row_sort_kernel
// (csrc/row_sort.cu); the flip and cross passes between merge levels stay
// elementwise torch ops in sage_tpu_torch/ops/pallas_sort.py, as they
// were XLA ops outside any Pallas kernel in the JAX package.
//
// Design. One CTA owns one block of CB keys (a power of two, at most 2^15:
// 128 KiB of dynamic shared memory, under the 227 KB a block can use).
// The CTA loads its block with coalesced reads, runs the log2 CB
// substages of the merge in shared memory with one __syncthreads() per
// substage, and writes the block back coalesced. Each thread takes
// CB / 2 / blockDim pairs per substage. Keys are plain int32: every
// correct merge gives one output, so the result is bit-equal to
// torch.sort of the block and to the plain version.
//
// What bounds it on an H100. The least work is one read and one write of
// every key (8 bytes a key at 3.35 TB/s). The merge does CB/2 log2 CB
// compare-exchanges a block, each a few shared-memory accesses, so it is
// bound by shared-memory traffic and the barriers between substages, not
// by device memory: it touches device memory exactly once each way.

#include <cuda_runtime.h>

namespace {

constexpr int kMaxThreads = 1024;

__global__ void __launch_bounds__(kMaxThreads)
bitonic_merge_blocks_kernel(const int* __restrict__ in, int* __restrict__ out,
                            int CB) {
    extern __shared__ int s[];
    const long long off = (long long)blockIdx.x * CB;
    for (int i = threadIdx.x; i < CB; i += blockDim.x) s[i] = in[off + i];
    __syncthreads();
    for (int j = CB >> 1; j > 0; j >>= 1) {
        for (int t = threadIdx.x; t < (CB >> 1); t += blockDim.x) {
            // i has bit j clear; its partner is i + j; every pair ascending
            const int i = ((t & ~(j - 1)) << 1) | (t & (j - 1));
            const int a = s[i];
            const int b = s[i + j];
            s[i] = min(a, b);
            s[i + j] = max(a, b);
        }
        __syncthreads();
    }
    for (int i = threadIdx.x; i < CB; i += blockDim.x) out[off + i] = s[i];
}

int threads_for(int CB) {
    const int t = CB >> 1;
    return t < 32 ? 32 : (t > kMaxThreads ? kMaxThreads : t);
}

}  // namespace

extern "C" {

// Ascending bitonic merge of each contiguous CB-key block of `in` (each
// block must be bitonic) into `out`; `nblocks` blocks. Returns
// cudaGetLastError() after the launch (0 on success).
int bitonic_merge_blocks(const void* in, void* out, int nblocks, int CB,
                         void* stream) {
    if (nblocks <= 0) return 0;
    const long long smem = 4LL * CB;
    if (smem > 48 * 1024) {
        const cudaError_t e = cudaFuncSetAttribute(
            bitonic_merge_blocks_kernel,
            cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
        if (e != cudaSuccess) return (int)e;
    }
    bitonic_merge_blocks_kernel<<<nblocks, threads_for(CB), (size_t)smem,
                                  (cudaStream_t)stream>>>(
        (const int*)in, (int*)out, CB);
    return (int)cudaGetLastError();
}

}  // extern "C"
