// LSD radix sort of i32 rows in shared memory, hand-written for Hopper
// (sm_90a).
//
// Replaces the TPU kernel sage_tpu/ops/pallas_sort.py::_sort_kernel (the
// one-pass ascending sort of a row). row_sort_kernel sorts each row of up
// to 2^15 keys exactly (no padding to a power of two); longer rows go to
// cluster_sort_kernel (csrc/cluster_sort.cu).
//
// What bounds it on an H100. The least work is one read and one write of
// every key (8 bytes a key at 3.35 TB/s); at the open search's rows the
// bytes are the larger bound. A bitonic network in shared memory (the
// TPU kernel's algorithm) does log2 n (log2 n + 1) / 2 substages over the
// row padded to a power of two, each a block-wide barrier and two loads
// and two stores of shared memory per pair: about 240 shared-memory
// accesses a key at 2^15 keys, bound by the shared-memory pipe and the
// barriers, not by the bytes.
//
// Design. One CTA owns one row of n <= 2^15 keys; each thread holds
// KPT of them in registers (KPT = 8, 16 or 32 by n, at most 32 warps),
// warp-striped: lane l of warp w holds positions w * seg + i * 32 + l,
// i < seg / 32 (seg = 32 KPT at the load), so loads and stores of device
// memory are coalesced and each round i of a warp covers 32 consecutive
// positions. The sign bit is flipped (k ^ 0x80000000) so that unsigned
// order is i32 order over the whole range.
//
// Keys equal to INT32_MAX are not ranked: they are the largest i32, so
// they go to the end of the row, after every ranked key. They are the
// open search's invalid entries, 83-92% of its rows on the bench's open
// workload. When the row holds any, the ranked keys are first compacted
// to the front of the exchange buffer in position order (a ballot per
// round and a scan over warps) and spread evenly over the warps again
// (seg = ceil(nr / warps), rounded up to 32): a warp's rounds are a chain
// of dependent steps, so a pass takes as long as its longest warp.
//
// Four passes of 8-bit digits, least significant first; a pass whose
// digit is the same for every ranked key of the row (from a block-wide
// OR and AND of them) is skipped, as a stable pass over a constant digit
// keeps the order. Each pass:
//   1. count: per round, __match_any_sync on the digit groups the warp's
//      equal digits; each group's lowest lane adds the group's size to
//      the warp's private 256-bin histogram in shared memory;
//   2. scan: an exclusive prefix over (digit, warp) in digit-major order
//      turns the histograms into each warp's first position per digit
//      (digit columns summed over warps, then one warp scans the 256
//      digit totals with shuffles);
//   3. scatter: the rounds again, in order; each group's leader takes
//      its digit's next position from the warp's counters and advances
//      them by the group's size, and each lane writes its key to
//      leader position + its rank among the group's lower lanes. Keys of
//      one digit keep the order of their positions (rounds in order,
//      lanes in order, warps in order): the pass is stable;
//   4. read back into registers from the exchange buffer.
// Five barriers a pass and about a dozen shared-memory accesses a
// ranked key over the four passes. Shared memory: the exchange buffer
// (4 bytes a key, 128 KiB at 2^15) and the histograms (1 KiB a warp), at
// most 160 KiB. The hardware match costs more the more distinct digits a
// warp holds; grouping by one ballot per digit bit instead was slower on
// the open search's rows, which repeat peptides, and faster only on rows
// of distinct random keys (on an H100). With KPT = 32 the kernel needs
// more than the 64 registers a thread can have at 1024 threads, and
// ptxas spills about 150 bytes a thread; capping the block at fewer
// threads to give it more registers halved the CTAs an SM holds for
// 16,384-key rows and was slower.
// Keys are plain int32: every correct sort gives one output, so the
// result is bit-equal to torch.sort and to the plain version.

#include <cuda_runtime.h>

namespace {

constexpr int kBits = 8;
constexpr int kBins = 1 << kBits;
constexpr int kPasses = 32 / kBits;
constexpr unsigned kFull = 0xffffffffu;
constexpr unsigned kSign = 0x80000000u;

template <int KPT>
__global__ void __launch_bounds__(1024)
row_sort_kernel(const int* __restrict__ in, int* __restrict__ out, int F) {
    extern __shared__ unsigned smem[];
    const int nw = blockDim.x >> 5;
    unsigned* buf = smem;                                 // [nw * 32 * KPT]
    int* hist = (int*)(smem + nw * 32 * KPT);             // [nw, kBins]
    __shared__ int tot[kBins];
    __shared__ unsigned red[3];

    const int warp = threadIdx.x >> 5;
    const int lane = threadIdx.x & 31;
    const unsigned lt = (1u << lane) - 1u;
    const long long row = blockIdx.x;
    const int n = F;  // keys in the row
    int seg = 32 * KPT;      // positions a warp holds, a multiple of 32
    int wpos = warp * seg;   // the warp's first position
    int* h = hist + warp * kBins;

    // Load (flipped). Keys equal to INT32_MAX (kFull once flipped) are
    // not ranked: they are the largest i32 and go to the end of the
    // row. The ranked keys' OR, AND and count.
    const int* src = in + row * F;
    unsigned k[KPT];
    unsigned k_or = 0, k_and = kFull;
    int cnt = 0;
#pragma unroll
    for (int i = 0; i < KPT; ++i) {
        const int p = wpos + i * 32 + lane;
        k[i] = p < n ? (unsigned)src[p] ^ kSign : kFull;
        if (k[i] != kFull) {
            k_or |= k[i];
            k_and &= k[i];
            ++cnt;
        }
    }
    if (threadIdx.x == 0) {
        red[0] = 0;
        red[1] = kFull;
        red[2] = 0;
    }
    __syncthreads();
    k_or = __reduce_or_sync(kFull, k_or);
    k_and = __reduce_and_sync(kFull, k_and);
    cnt = __reduce_add_sync(kFull, cnt);
    if (lane == 0) {
        atomicOr(&red[0], k_or);
        atomicAnd(&red[1], k_and);
        atomicAdd(&red[2], (unsigned)cnt);
    }
    __syncthreads();
    const int nr = (int)red[2];  // ranked keys
    const unsigned vary = nr > 1 ? red[0] ^ red[1] : 0u;

    int lim = n;          // positions that may hold ranked keys
    bool in_buf = false;  // the ranked keys, sorted so far, are buf[0, nr)
    if (nr < n) {         // block-uniform
        // Compact the ranked keys to buf[0, nr) in position order: each
        // warp's count, an exclusive scan over warps, then each round's
        // ranked lanes at the warp's offset plus their rank in the round.
        // The passes then spread the nr keys evenly over the warps: a
        // warp's rounds are a chain of dependent steps, so the time of a
        // pass is the longest warp's.
        int wc = 0;
#pragma unroll
        for (int i = 0; i < KPT; ++i) {
            if (wpos + i * 32 >= n) break;
            wc += __popc(__ballot_sync(kFull, k[i] != kFull));
        }
        if (lane == 0) tot[warp] = wc;
        __syncthreads();
        if (warp == 0) {
            const int v = lane < nw ? tot[lane] : 0;
            int incl = v;
#pragma unroll
            for (int off = 1; off < 32; off <<= 1) {
                const int y = __shfl_up_sync(kFull, incl, off);
                if (lane >= off) incl += y;
            }
            if (lane < nw) tot[lane] = incl - v;
        }
        __syncthreads();
        int at = tot[warp];
#pragma unroll
        for (int i = 0; i < KPT; ++i) {
            if (wpos + i * 32 >= n) break;
            const bool r = k[i] != kFull;
            const unsigned b = __ballot_sync(kFull, r);
            if (r) buf[at + __popc(b & lt)] = k[i];
            at += __popc(b);
        }
        __syncthreads();
        lim = nr;
        in_buf = true;
        seg = ((nr + nw - 1) / nw + 31) & ~31;
        wpos = warp * seg;
    }
    for (int pass = 0; pass < kPasses; ++pass) {
        const int shift = pass * kBits;
        if (((vary >> shift) & (kBins - 1)) == 0) continue;  // block-uniform
        // the warp's rounds; a lane without a ranked key holds kFull
        const int left = lim - wpos;
        const int rounds = max(0, min(seg, left + 31) >> 5);
        if (in_buf) {
            const int rem = left - lane;
#pragma unroll
            for (int i = 0; i < KPT; ++i) {
                if (i >= rounds) break;
                k[i] = i * 32 < rem ? buf[wpos + i * 32 + lane] : kFull;
            }
        }
        for (int d = lane; d < kBins; d += 32) h[d] = 0;
        __syncwarp();
        // 1. count
#pragma unroll
        for (int i = 0; i < KPT; ++i) {
            if (i >= rounds) break;  // warp-uniform
            const bool real = k[i] != kFull;
            const unsigned d = (k[i] >> shift) & (kBins - 1);
            const unsigned peers =
                __match_any_sync(kFull, real ? (int)d : kBins);
            if (real && lane == __ffs(peers) - 1)
                atomicAdd(&h[d], __popc(peers));
        }
        __syncthreads();
        // 2. scan over (digit, warp), digit-major
        for (int d = threadIdx.x; d < kBins; d += blockDim.x) {
            int run = 0;
            for (int w = 0; w < nw; ++w) {
                const int c = hist[w * kBins + d];
                hist[w * kBins + d] = run;
                run += c;
            }
            tot[d] = run;
        }
        __syncthreads();
        if (warp == 0) {
            constexpr int kPer = kBins / 32;
            int v[kPer];
            int s = 0;
#pragma unroll
            for (int j = 0; j < kPer; ++j) {
                v[j] = tot[lane * kPer + j];
                s += v[j];
            }
            int incl = s;
#pragma unroll
            for (int off = 1; off < 32; off <<= 1) {
                const int y = __shfl_up_sync(kFull, incl, off);
                if (lane >= off) incl += y;
            }
            int run = incl - s;
#pragma unroll
            for (int j = 0; j < kPer; ++j) {
                tot[lane * kPer + j] = run;
                run += v[j];
            }
        }
        __syncthreads();
        for (int d = threadIdx.x; d < kBins; d += blockDim.x) {
            const int b = tot[d];
            for (int w = 0; w < nw; ++w) hist[w * kBins + d] += b;
        }
        __syncthreads();
        // 3. scatter, rounds and lanes in position order
#pragma unroll
        for (int i = 0; i < KPT; ++i) {
            if (i >= rounds) break;
            const bool real = k[i] != kFull;
            const unsigned d = (k[i] >> shift) & (kBins - 1);
            const unsigned peers =
                __match_any_sync(kFull, real ? (int)d : kBins);
            const int leader = __ffs(peers) - 1;
            int at = 0;
            if (real && lane == leader) {
                at = h[d];
                h[d] = at + __popc(peers);
            }
            at = __shfl_sync(kFull, at, leader);
            if (real) buf[at + __popc(peers & lt)] = k[i];
            __syncwarp();
        }
        __syncthreads();
        in_buf = true;
        lim = nr;  // the ranked keys are now buf[0, nr), in order
    }

    // 4. Write the nr ranked keys in order (when no pass ran, every
    // ranked key equals red[0]), then the n - nr INT32_MAX keys.
    const unsigned one = red[0];
    int* dst = out + row * F;
    for (int q = threadIdx.x; q < n; q += blockDim.x) {
        unsigned v = kFull;
        if (q < nr) v = in_buf ? buf[q] : one;
        dst[q] = (int)(v ^ kSign);
    }
}

template <int KPT>
int launch(const int* in, int* out, int rows, int F, cudaStream_t stream) {
    const int nw = (F + 32 * KPT - 1) / (32 * KPT);
    const long long smem = 4LL * nw * (32 * KPT + kBins);
    if (smem > 48 * 1024) {
        const cudaError_t e = cudaFuncSetAttribute(
            row_sort_kernel<KPT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
            (int)smem);
        if (e != cudaSuccess) return (int)e;
    }
    row_sort_kernel<KPT><<<rows, nw * 32, (size_t)smem, stream>>>(in, out, F);
    return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Sorts each F-key row of `in` ascending into `out` (rows * F int32),
// F in [1, 2^15]. Returns cudaGetLastError() after the launch (0 on
// success).
int row_sort(const void* in, void* out, int rows, int F, void* stream) {
    if (rows <= 0 || F <= 0) return 0;
    const int* i = (const int*)in;
    int* o = (int*)out;
    cudaStream_t s = (cudaStream_t)stream;
    if (F <= 2048) return launch<8>(i, o, rows, F, s);
    if (F <= 8192) return launch<16>(i, o, rows, F, s);
    return launch<32>(i, o, rows, F, s);
}

}  // extern "C"
