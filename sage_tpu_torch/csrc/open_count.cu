// The run-count top-K of the peak-major searches, hand-written for Hopper
// (sm_90a).
//
// Replaces the XLA program (no Pallas kernel) that sage_tpu's
// _open_count_core (sage_tpu/ops/open_search.py:465) runs after its sort,
// whose plain version, open_count_plain (ops/open_search.py), loops over
// chunks of query rows: a gather of each row's pseudo-row into a fresh
// [n, F] tensor, masks, cumsum, cummax and torch.topk over an int64
// [n, F] key.
//
// Input: the sorted pseudo-rows, peptide-descending with the entries
// that hold no peptide last (so the live entries are a prefix), in one of
// three forms: the sort kernels' packed key ((2^25 - pep) << 5) | z, or
// 2^25 - pep with one fragment-charge plane, INT32_MAX where empty; or
// torch.sort's -pep (2^30 where empty) with the charge tags in a second
// array. Only the first Fax columns of a row count (the plain version
// cuts the sorted rows to F).
//
// Per query row r (spectrum, precursor range [i0, i1), exclusive
// fragment-charge bound maxz) and each of its nbcov band pseudo-rows
// spec * nbcov + slot (clamped to the table, as the plain version's
// gather clamps a padding row's sentinel): a peptide run's count is the
// number of its entries with i0 <= pep < i1 and, with more than one
// charge plane, z < maxz (one plane: the run's length). matched_total is
// the sum of the counts, scored the number of runs whose count is > 0,
// and the top K runs by (count desc, peptide desc) give vals and cand,
// zeros past the runs with a positive count: the plain version's
// (count desc, position asc) order, since positions ascend as peptides
// descend. Output: the [R, 2K+2] i32 layout (vals[K], cand[K],
// matched_total, scored).
//
// Exactness. Runs are delimited by the peptide alone, the charge mask is
// per entry, so the order of entries inside a run changes no count (the
// two sorts order them differently). Because a row is sorted, the
// entries with i0 <= pep < i1 are one contiguous range [a, b) of its live
// prefix, and [a, b) starts and ends on run boundaries; the block finds
// the live end and a and b by warp-wide searches (32 probes a step, not a
// scan of F) and walks only [a, b). A row cut at Fax keeps the runs the
// cut leaves, as the plain version's cut does. With nbcov > 1 the plain
// version keeps a top K in each band and merges the nbcov * K winners by
// (count desc, peptide desc); here one top K is kept over all the bands'
// runs. The two agree only because bands partition peptide ids: no
// peptide has runs in two band pseudo-rows, so every (count, peptide) key
// is distinct and every global winner is among its band's top K. A
// caller whose pseudo-rows of one query row shared a peptide would need
// the per-band form.
//
// The top K: each run with a positive count is a 64-bit key
// (count << 32) | pep, distinct for every run. Keys above the current
// threshold (the K-th largest kept so far, 0 at first) go into a buffer
// in shared memory; when the buffer nears its end the block sorts it
// (a bitonic sort, descending), keeps K and raises the threshold. At the
// end the buffer is sorted once more and its first K written. Exact for
// every K up to kMaxK: a key at or below the threshold has K larger keys
// already kept.
//
// What bounds it on an H100. Bytes: each query row reads its window's
// entries (a few log-steps to find them) and writes 2K + 2 i32; nothing
// is written per entry. Design: one block a query row; thread t takes
// positions a + t, a + t + 256, ...; a thread at a run's first position
// walks the run (the same lines its neighbours read), counts it and
// offers its key.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kCap = 4096;  // keys the buffer holds (32 KB)
constexpr int kMaxK = 1024;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kPMax = 1 << 25;
constexpr int kNoPep = 1 << 30;
constexpr int kInt32Max = 0x7fffffff;

enum Mode { kPackedNoZ = 0, kPackedZ = 1, kNeg = 2 };

struct Row {
    const int* v;  // the sorted keys
    const int* z;  // the charge tags (kNeg with Z > 1), else null
    int mode;
    __device__ __forceinline__ bool live(long long j) const {
        const int x = __ldg(v + j);
        return mode == kNeg ? x < kNoPep : x != kInt32Max;
    }
    // the peptide id of a live entry
    __device__ __forceinline__ int pep(long long j) const {
        const int x = __ldg(v + j);
        return mode == kNeg ? -x : (mode == kPackedZ ? kPMax - (x >> 5)
                                                     : kPMax - x);
    }
    __device__ __forceinline__ int zt(long long j) const {
        return mode == kNeg ? __ldg(z + j) : (__ldg(v + j) & 31);
    }
};

// Warp-wide: the first x in [lo, hi) where pred(x) holds, hi if none
// (pred false then true over the range). 32 probes a step.
template <class P>
__device__ long long warp_first(long long lo, long long hi, P pred) {
    const int lane = threadIdx.x & 31;
    // the answer lies in [lo, hi]; lane l probes lo + (l + 1) * step - 1,
    // a probe at or past hi counting as true
    while (lo < hi) {
        const long long step = (hi - lo + 31) / 32;
        const long long x = lo + (long long)(lane + 1) * step - 1;
        const unsigned bal = __ballot_sync(kFull, x >= hi || pred(x));
        if (bal == 0) return hi;  // every probe, hi - 1 among them, false
        const int f = __ffs(bal) - 1;
        const long long xf = lo + (long long)(f + 1) * step - 1;
        lo += (long long)f * step;
        hi = xf < hi ? xf : hi;
    }
    return hi;
}

// descending bitonic sort of buf[0, n), n a power of two
__device__ void sort_desc(unsigned long long* buf, int n) {
    for (int k = 2; k <= n; k <<= 1) {
        for (int j = k >> 1; j > 0; j >>= 1) {
            for (int i = threadIdx.x; i < n; i += kThreads) {
                const int ix = i ^ j;
                if (ix > i) {
                    const unsigned long long a = buf[i], c = buf[ix];
                    const bool up = (i & k) == 0;
                    if (up ? (a < c) : (a > c)) {
                        buf[i] = c;
                        buf[ix] = a;
                    }
                }
            }
            __syncthreads();
        }
    }
}

__device__ int pow2_at_least(int n) {
    int p = 1;
    while (p < n) p <<= 1;
    return p;
}

// Sort the buffer's n keys (zero-padded to a power of two), descending.
__device__ void sort_buffer(unsigned long long* buf, int n) {
    const int n2 = pow2_at_least(n < 2 ? 2 : n);
    for (int i = n + threadIdx.x; i < n2; i += kThreads) buf[i] = 0ull;
    __syncthreads();
    sort_desc(buf, n2);
}

__global__ void __launch_bounds__(kThreads)
open_count_kernel(
    const int* __restrict__ rows, long long stride,
    const int* __restrict__ zs, long long zstride, int BN, int Fax,
    int mode, int has_z, const int* __restrict__ row_spec,
    const int* __restrict__ row_i0, const int* __restrict__ row_i1,
    const int* __restrict__ row_maxz, int nbcov, int K,
    int* __restrict__ out) {
    __shared__ unsigned long long buf[kCap];
    __shared__ unsigned long long thr;
    __shared__ int n_buf;
    __shared__ long long range[2];
    __shared__ int red[2][kThreads / 32];
    const int tid = threadIdx.x;
    const int lane = tid & 31;
    const int warp = tid >> 5;
    const long long r = blockIdx.x;
    const int i0 = row_i0[r], i1 = row_i1[r], maxz = row_maxz[r];
    const long long spec = row_spec[r];
    if (tid == 0) {
        thr = 0ull;
        n_buf = 0;
    }
    int mt = 0, sc = 0;
    __syncthreads();
    for (int slot = 0; slot < nbcov && i0 < i1; ++slot) {
        long long p = spec * nbcov + slot;
        p = p < 0 ? 0 : (p >= BN ? BN - 1 : p);
        const Row row{rows + p * stride, zs ? zs + p * zstride : nullptr,
                      mode};
        if (warp == 0) {
            const long long live = warp_first(
                0, Fax, [&](long long j) { return !row.live(j); });
            const long long a = warp_first(
                0, live, [&](long long j) { return row.pep(j) < i1; });
            const long long b = warp_first(
                a, live, [&](long long j) { return row.pep(j) < i0; });
            if (lane == 0) {
                range[0] = a;
                range[1] = b;
            }
        }
        __syncthreads();
        const long long a = range[0], b = range[1];
        for (long long base = a; base < b; base += kThreads) {
            const long long j = base + tid;
            unsigned long long key = 0ull;
            if (j < b) {
                const int pj = row.pep(j);
                if (j == a || row.pep(j - 1) != pj) {
                    int c = 0;
                    for (long long x = j; x < b && row.pep(x) == pj; ++x) {
                        if (!has_z || row.zt(x) < maxz) ++c;
                    }
                    if (c > 0) {
                        key = ((unsigned long long)c << 32) | (unsigned)pj;
                        mt += c;
                        ++sc;
                    }
                }
            }
            if (key > thr) buf[atomicAdd(&n_buf, 1)] = key;
            __syncthreads();
            if (n_buf > kCap - kThreads) {
                const int n = n_buf;
                sort_buffer(buf, n);
                if (tid == 0) {
                    n_buf = K;  // n > kCap - kThreads >= K
                    thr = buf[K - 1];
                }
            }
            __syncthreads();
        }
        __syncthreads();  // range[] is rewritten for the next slot
    }
    const int n = n_buf;
    sort_buffer(buf, n);
    int* o = out + r * (2LL * K + 2);
    for (int i = tid; i < K; i += kThreads) {
        const unsigned long long key = i < n ? buf[i] : 0ull;
        o[i] = (int)(key >> 32);
        o[K + i] = (int)(key & 0xffffffffull);
    }
    // block sums of matched_total and scored
    for (int off = 16; off > 0; off >>= 1) {
        mt += __shfl_down_sync(kFull, mt, off);
        sc += __shfl_down_sync(kFull, sc, off);
    }
    if (lane == 0) {
        red[0][warp] = mt;
        red[1][warp] = sc;
    }
    __syncthreads();
    if (tid == 0) {
        int m = 0, s = 0;
        for (int w = 0; w < kThreads / 32; ++w) {
            m += red[0][w];
            s += red[1][w];
        }
        o[2 * K] = m;
        o[2 * K + 1] = s;
    }
}

}  // namespace

extern "C" {

int open_count_max_k() { return kMaxK; }

// Launches the count on `stream`; returns cudaGetLastError() after the
// launch (0 on success). Device pointers: rows i32 [BN, >= Fax] with row
// stride `stride`, zs i32 (or null) with row stride `zstride`, row_spec,
// row_i0, row_i1, row_maxz i32 [R], out i32 [R, 2K + 2]. mode: 0 packed
// keys without a charge tag, 1 packed with one, 2 -pep keys (tags in zs
// when has_z).
int open_count(const void* rows, long long stride, const void* zs,
               long long zstride, int BN, int Fax, int mode, int has_z,
               const void* row_spec, const void* row_i0, const void* row_i1,
               const void* row_maxz, int R, int nbcov, int K, void* out,
               void* stream) {
    if (R <= 0) return 0;
    if (K < 1 || K > kMaxK || BN < 1 || Fax < 0 || nbcov < 1)
        return (int)cudaErrorInvalidValue;
    open_count_kernel<<<(unsigned)R, kThreads, 0, (cudaStream_t)stream>>>(
        (const int*)rows, stride, (const int*)zs, zstride, BN, Fax, mode,
        has_z, (const int*)row_spec, (const int*)row_i0,
        (const int*)row_i1, (const int*)row_maxz, nbcov, K, (int*)out);
    return (int)cudaGetLastError();
}

}  // extern "C"
