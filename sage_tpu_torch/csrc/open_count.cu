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
// array; and each pseudo-row's live count, the length of that prefix, as
// the entry gather wrote it (open_entries.cu). Only the first Fax columns
// of a row count (the plain version cuts the sorted rows to F).
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
// Exactness.
// - A sorted row's window is one contiguous, run-aligned range of its
//   live prefix. Runs are delimited by the peptide alone and the charge
//   mask is per entry, so the order of entries inside a run changes no
//   count (the two sorts order them differently). Because a row is
//   sorted, the entries with i0 <= pep < i1 are one range [a, b) of the
//   live prefix [0, min(live, Fax)), and [a, b) starts and ends on run
//   boundaries: a is the first position with pep < i1, b the first with
//   pep < i0, two searches of one monotone predicate each. A row cut at
//   Fax keeps the runs the cut leaves, as the plain version's cut does.
// - A run's count does not depend on how the window is stepped through:
//   the warp form sums its positions' charge mask 32 positions at a time
//   and carries a run still open at a step's end into the next step, the
//   block form walks it from its first position; both offer each run
//   once, when it is whole.
// - Bands partition peptide ids, so one top K over the nbcov band
//   pseudo-rows equals the per-band merge. With nbcov > 1 the plain
//   version keeps a top K in each band and merges the nbcov * K winners
//   by (count desc, peptide desc); here one top K is kept over all the
//   bands' runs. No peptide has runs in two band pseudo-rows, so every
//   (count, peptide) key is distinct and every global winner is among its
//   band's top K. A caller whose pseudo-rows of one query row shared a
//   peptide would need the per-band form.
// - The top K: each run with a positive count is a 64-bit key
//   (count << 32) | pep, distinct for every run. Keys above the current
//   threshold (the K-th largest kept so far, 0 at first) go into a
//   buffer in shared memory of cap keys; when it holds more than cap - T
//   (T the keys one step can add: 32 or 256) it is sorted (a bitonic
//   sort, descending), cut to K and the threshold raised; cap - T >= K.
//   At the end the buffer is sorted once more and its first K written.
//   Exact for every K up to kMaxK, in any order of offers: a key at or
//   below the rising threshold already has K larger keys kept.
//
// What bounds it on an H100. Bytes: each query row reads its window's
// entries and writes 2K + 2 i32; nothing is written per entry. The time
// goes to dependent loads (a search's steps, a window's steps) and to
// instructions, and the design cuts both and keeps many rows in flight.
// The live end is not searched: it is the gather's live count. Two
// forms, chosen by K alone:
// - K <= kWarpMaxK (bench.py's K = 50): a warp a query row, kWarpRows a
//   block, a buffer of kWarpCap keys a warp (1 KB). Up to 16 band
//   pseudo-rows are searched at once, both ends of each window by a group
//   of G lanes (G = 16 for one row: a 17-way split a step, so 3 steps
//   over 2,560 entries), all groups' loads in flight together. The
//   window is read 32 positions a step, one coalesced load a lane (the
//   next step's load issued before this step's work): a run starts where
//   the peptide changes, its count is the popcount of the charge mask
//   over its lanes (ballots), so no lane walks a run. Sorts run in
//   registers (a bitonic network, shuffles across lanes), the last one
//   only as wide as the keys kept.
// - K up to kMaxK: a block of kThreads a query row, its buffer a power
//   of two of at least 2K + kThreads keys (4096, 32 KB, at K 1024), one
//   thread's binary searches a band pseudo-row, all before the first
//   barrier; a thread at a run's first position walks the run (the lines
//   its neighbours read), counts it and offers its key.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;    // the block form: threads a query row
constexpr int kWarpRows = 4;     // the warp form: query rows a block
constexpr int kWarpMaxK = 64;
constexpr int kWarpCap = 128;    // the warp form's buffer, in keys
constexpr int kMaxK = 1024;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kPMax = 1 << 25;

enum Mode { kPackedNoZ = 0, kPackedZ = 1, kNeg = 2 };

// the peptide id of a live entry's key x
__device__ __forceinline__ int pep_of(int x, int mode) {
    return mode == kNeg ? -x : (mode == kPackedZ ? kPMax - (x >> 5)
                                                 : kPMax - x);
}

struct Row {
    const int* v;  // the sorted keys
    const int* z;  // the charge tags (kNeg with Z > 1), else null
    int mode;
    // the peptide id of a live entry
    __device__ __forceinline__ int pep(long long j) const {
        return pep_of(__ldg(v + j), mode);
    }
    __device__ __forceinline__ int zt(long long j) const {
        return mode == kNeg ? __ldg(z + j) : (__ldg(v + j) & 31);
    }
};

struct Args {
    const int* rows;
    long long stride;
    const int* zs;
    long long zstride;
    const int* live;
    int BN, Fax, mode, has_z;
    const int* row_spec;
    const int* row_i0;
    const int* row_i1;
    const int* row_maxz;
    int R, nbcov, K, cap;
    int* out;

    __device__ __forceinline__ long long pseudo(long long spec,
                                                int slot) const {
        const long long p = spec * nbcov + slot;
        return p < 0 ? 0 : (p >= BN ? BN - 1 : p);
    }
    __device__ __forceinline__ Row row(long long p) const {
        return Row{rows + p * stride, zs ? zs + p * zstride : nullptr, mode};
    }
    // pseudo-row p's window [a, b) of [i0, i1): two binary searches over
    // its live prefix, their probes issued together
    __device__ void window(long long p, int i0, int i1, int& a,
                           int& b) const {
        const Row rw = row(p);
        int n = __ldg(live + p);
        n = n < 0 ? 0 : (n > Fax ? Fax : n);
        int la = 0, ha = n, lb = 0, hb = n;
        while (la < ha || lb < hb) {
            const int ma = (la + ha) >> 1, mb = (lb + hb) >> 1;
            const int pa = rw.pep(ma < n ? ma : n - 1);
            const int pb = rw.pep(mb < n ? mb : n - 1);
            if (la < ha) {
                if (pa < i1) ha = ma; else la = ma + 1;
            }
            if (lb < hb) {
                if (pb < i0) hb = mb; else lb = mb + 1;
            }
        }
        a = la;
        b = lb;
    }
    // the run starting at j of [a, b) if one does: its masked count
    __device__ __forceinline__ int run_at(const Row& rw, long long j,
                                          long long a, long long b,
                                          int maxz, int& pj) const {
        pj = rw.pep(j);
        if (j != a && rw.pep(j - 1) == pj) return 0;
        int c = 0;
        for (long long x = j; x < b && rw.pep(x) == pj; ++x) {
            if (!has_z || rw.zt(x) < maxz) ++c;
        }
        return c;
    }
};

// descending bitonic sort of buf[0, n) by the block, n a power of two
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

__host__ __device__ __forceinline__ int pow2_at_least(int n) {
    int p = 1;
    while (p < n) p <<= 1;
    return p;
}

// Sort the buffer's n keys (zero-padded to a power of two) by the block,
// descending.
__device__ void sort_buffer(unsigned long long* buf, int n) {
    const int n2 = pow2_at_least(n < 2 ? 2 : n);
    for (int i = n + threadIdx.x; i < n2; i += kThreads) buf[i] = 0ull;
    __syncthreads();
    sort_desc(buf, n2);
}

// Descending bitonic sort of a warp's 32 * E keys in registers (E a
// power of two), key lane * E + e in x[e]: pairs inside a lane are
// swapped in place, pairs across lanes exchanged by shuffles. The loops
// count linearly so that they unroll whole and x stays in registers.
template <int E>
__device__ __forceinline__ void warp_sort_desc(unsigned long long (&x)[E],
                                               int lane) {
    constexpr int kLog = E == 1 ? 5 : E == 2 ? 6 : E == 4 ? 7 : 8;
#pragma unroll
    for (int lk = 1; lk <= kLog; ++lk) {
        const int k = 1 << lk;
#pragma unroll
        for (int lj = lk - 1; lj >= 0; --lj) {
            const int j = 1 << lj;
#pragma unroll
            for (int e = 0; e < E; ++e) {
                const int i = lane * E + e;
                if (j < E) {
                    const int pe = e ^ j;
                    if (pe > e) {
                        const unsigned long long u = x[e], v = x[pe];
                        const bool sw = (i & k) == 0 ? u < v : u > v;
                        x[e] = sw ? v : u;
                        x[pe] = sw ? u : v;
                    }
                } else {
                    const unsigned long long v =
                        __shfl_xor_sync(kFull, x[e], j / E);
                    const bool hi = ((i & k) == 0) == ((i & j) == 0);
                    x[e] = hi ? (x[e] > v ? x[e] : v) : (x[e] < v ? x[e] : v);
                }
            }
        }
    }
}

// The buffer's first 32 * E keys (zeros past n) sorted into x,
// descending.
template <int E>
__device__ __forceinline__ void sorted(const unsigned long long* buf, int n,
                                       unsigned long long (&x)[E],
                                       int lane) {
    __syncwarp();
#pragma unroll
    for (int e = 0; e < E; ++e) {
        const int i = lane * E + e;
        x[e] = i < n ? buf[i] : 0ull;
    }
    warp_sort_desc<E>(x, lane);
}

// The first K of the buffer's n <= 32 * E keys, descending, as the
// output's vals[K] and cand[K] (zeros past n, and past 32 * E when K is
// larger).
template <int E>
__device__ __forceinline__ void write_top(const unsigned long long* buf,
                                          int n, int K, int* o, int lane) {
    unsigned long long x[E];
    sorted<E>(buf, n, x, lane);
#pragma unroll
    for (int e = 0; e < E; ++e) {
        const int i = lane * E + e;
        if (i < K) {
            o[i] = (int)(x[e] >> 32);
            o[K + i] = (int)(x[e] & 0xffffffffull);
        }
    }
    for (int i = 32 * E + lane; i < K; i += 32) {
        o[i] = 0;
        o[K + i] = 0;
    }
}

// A warp's top-K buffer of kWarpCap keys in shared memory behind its
// threshold; every member is warp-uniform.
struct WarpTopK {
    unsigned long long* buf;
    int K, n;
    unsigned long long thr;

    // the lanes whose key passes the threshold append it; past
    // kWarpCap - 32 keys the buffer is sorted, cut to K and the threshold
    // raised to its K-th key
    __device__ __forceinline__ void offer(unsigned long long key, int lane) {
        constexpr int E = kWarpCap / 32;
        const bool take = key > thr;
        const unsigned m = __ballot_sync(kFull, take);
        if (take) buf[n + __popc(m & ((1u << lane) - 1u))] = key;
        n += __popc(m);
        if (n > kWarpCap - 32) {
            unsigned long long x[E];
            sorted<E>(buf, n, x, lane);
#pragma unroll
            for (int e = 0; e < E; ++e) buf[lane * E + e] = x[e];
            __syncwarp();
            thr = buf[K - 1];
            n = K;  // n > kWarpCap - 32 >= kWarpMaxK >= K
            __syncwarp();
        }
    }
};

// The warp form: warp w of block x counts query row x * kWarpRows + w.
__global__ void __launch_bounds__(kWarpRows * 32)
open_count_warp_kernel(Args g) {
    extern __shared__ unsigned long long sbuf[];
    const int lane = threadIdx.x & 31;
    const int warp = threadIdx.x >> 5;
    const long long r = (long long)blockIdx.x * kWarpRows + warp;
    if (r >= g.R) return;  // no block barrier below
    WarpTopK top{sbuf + (size_t)warp * kWarpCap, g.K, 0, 0ull};
    const int i0 = g.row_i0[r], i1 = g.row_i1[r], maxz = g.row_maxz[r];
    const long long spec = g.row_spec[r];
    const bool zneg = g.has_z && g.mode == kNeg;
    int mt = 0, sc = 0;
    for (int s0 = 0; i0 < i1 && s0 < g.nbcov; s0 += 16) {
        // up to 16 band pseudo-rows at once: each end of each window is a
        // search by G lanes (G probes a step), all in flight together
        const int ns = g.nbcov - s0 < 16 ? g.nbcov - s0 : 16;
        int G = 16;
        while (G > 1 && 2 * ns * G > 32) G >>= 1;
        const int sidx = lane / G, gi = lane - sidx * G;
        int lo = 0, hi = 0, bound = 0;
        const int* sv = g.rows;
        if (sidx < 2 * ns) {
            const long long p = g.pseudo(spec, s0 + (sidx >> 1));
            sv = g.rows + p * g.stride;
            const int nl = __ldg(g.live + p);
            hi = nl < 0 ? 0 : (nl > g.Fax ? g.Fax : nl);
            bound = (sidx & 1) ? i0 : i1;
        }
        while (__any_sync(kFull, lo < hi)) {
            bool t = false;
            int step = 0;
            if (lo < hi) {
                step = (hi - lo + G) / (G + 1);
                const int x = lo + (gi + 1) * step - 1;
                t = x >= hi || pep_of(__ldg(sv + x), g.mode) < bound;
            }
            const unsigned bits =
                (__ballot_sync(kFull, t) >> (sidx * G)) & ((1u << G) - 1u);
            if (lo < hi) {
                const int f = bits ? __ffs(bits) - 1 : G;
                const int x = lo + (f + 1) * step - 1;
                lo += f * step;
                hi = f < G && x < hi ? x : hi;
            }
        }
        for (int q = 0; q < ns; ++q) {
            const int a = __shfl_sync(kFull, lo, 2 * q * G);
            const int b = __shfl_sync(kFull, lo, (2 * q + 1) * G);
            const long long p = g.pseudo(spec, s0 + q);
            const int* v = g.rows + p * g.stride;
            const int* zp = zneg ? g.zs + p * g.zstride : nullptr;
            // the window 32 positions a step, one coalesced load a lane
            // (the next step's issued first); a run's count is the
            // popcount of its lanes' charge mask, the run still open at a
            // step's end carried to the next (cc entries of peptide cp)
            int j = a + lane;
            int xk = j < b ? __ldg(v + j) : 0;
            int xz = zneg && j < b ? __ldg(zp + j) : 0;
            int cc = 0, cp = 0;
            bool open = false;
            for (int base = a; base < b; base += 32, j += 32) {
                const int jn = j + 32;
                const int nk = jn < b ? __ldg(v + jn) : 0;
                const int nz = zneg && jn < b ? __ldg(zp + jn) : 0;
                const bool in = j < b;
                const int pj = pep_of(xk, g.mode);
                const int zt = zneg ? xz : (xk & 31);
                const bool ok = in && (!g.has_z || zt < maxz);
                int prev = __shfl_up_sync(kFull, pj, 1);
                if (lane == 0) prev = cp;
                const bool start = in && (j == a || pj != prev);
                const unsigned S = __ballot_sync(kFull, start);
                const unsigned O = __ballot_sync(kFull, ok);
                const bool last = base + 32 >= b;
                if (open) {
                    // the open run ends at this step's first start
                    const int fs = S ? __ffs(S) - 1 : 32;
                    cc += __popc(O & (fs == 32 ? kFull : (1u << fs) - 1u));
                    if (fs < 32 || last) {
                        open = false;
                        unsigned long long key = 0ull;
                        if (lane == 0 && cc > 0) {
                            key = ((unsigned long long)cc << 32)
                                  | (unsigned)cp;
                            mt += cc;
                            ++sc;
                        }
                        top.offer(key, lane);
                    }
                }
                // the runs that start here; the last one stays open when
                // the window goes on
                const int ls = S ? 31 - __clz(S) : -1;
                unsigned long long key = 0ull;
                if (start && (lane != ls || last)) {
                    const unsigned above = S & ~((2u << lane) - 1u);
                    const unsigned span =
                        (above ? (above & (0u - above)) - 1u : kFull)
                        & ~((1u << lane) - 1u);
                    const int c = __popc(O & span);
                    if (c > 0) {
                        key = ((unsigned long long)c << 32) | (unsigned)pj;
                        mt += c;
                        ++sc;
                    }
                }
                top.offer(key, lane);
                if (ls >= 0 && !last) {
                    open = true;
                    cc = __popc(O & ~((1u << ls) - 1u));
                    cp = __shfl_sync(kFull, pj, ls);
                }
                xk = nk;
                xz = nz;
            }
        }
    }
    // the final sort only as wide as the keys kept
    int* o = g.out + r * (2LL * g.K + 2);
    if (top.n <= 32) {
        write_top<1>(top.buf, top.n, g.K, o, lane);
    } else if (top.n <= 64) {
        write_top<2>(top.buf, top.n, g.K, o, lane);
    } else {
        write_top<kWarpCap / 32>(top.buf, top.n, g.K, o, lane);
    }
    mt = __reduce_add_sync(kFull, mt);
    sc = __reduce_add_sync(kFull, sc);
    if (lane == 0) {
        o[2 * g.K] = mt;
        o[2 * g.K + 1] = sc;
    }
}

// The block form: block x counts query row x.
__global__ void __launch_bounds__(kThreads)
open_count_block_kernel(Args g) {
    extern __shared__ unsigned long long buf[];
    __shared__ int2 range[kThreads];
    __shared__ unsigned long long thr;
    __shared__ int n_buf;
    __shared__ int red[2][kThreads / 32];
    const int tid = threadIdx.x;
    const int lane = tid & 31;
    const int warp = tid >> 5;
    const long long r = blockIdx.x;
    const int i0 = g.row_i0[r], i1 = g.row_i1[r], maxz = g.row_maxz[r];
    const long long spec = g.row_spec[r];
    if (tid == 0) {
        thr = 0ull;
        n_buf = 0;
    }
    int mt = 0, sc = 0;
    __syncthreads();
    for (int s0 = 0; i0 < i1 && s0 < g.nbcov; s0 += kThreads) {
        // thread t: slot s0 + t's window
        if (s0 + tid < g.nbcov) {
            int a, b;
            g.window(g.pseudo(spec, s0 + tid), i0, i1, a, b);
            range[tid] = make_int2(a, b);
        }
        __syncthreads();
        const int ns = g.nbcov - s0 < kThreads ? g.nbcov - s0 : kThreads;
        for (int q = 0; q < ns; ++q) {
            const int a = range[q].x, b = range[q].y;
            const Row rw = g.row(g.pseudo(spec, s0 + q));
            for (int base = a; base < b; base += kThreads) {
                const int j = base + tid;
                unsigned long long key = 0ull;
                if (j < b) {
                    int pj;
                    const int c = g.run_at(rw, j, a, b, maxz, pj);
                    if (c > 0) {
                        key = ((unsigned long long)c << 32) | (unsigned)pj;
                        mt += c;
                        ++sc;
                    }
                }
                if (key > thr) buf[atomicAdd(&n_buf, 1)] = key;
                __syncthreads();
                if (n_buf > g.cap - kThreads) {
                    const int n = n_buf;
                    sort_buffer(buf, n);
                    if (tid == 0) {
                        n_buf = g.K;  // n > cap - kThreads >= 2K
                        thr = buf[g.K - 1];
                    }
                }
                __syncthreads();
            }
        }
        __syncthreads();  // range[] is rewritten for the next slots
    }
    const int n = n_buf;
    sort_buffer(buf, n);
    int* o = g.out + r * (2LL * g.K + 2);
    for (int i = tid; i < g.K; i += kThreads) {
        const unsigned long long key = i < n ? buf[i] : 0ull;
        o[i] = (int)(key >> 32);
        o[g.K + i] = (int)(key & 0xffffffffull);
    }
    // block sums of matched_total and scored
    mt = __reduce_add_sync(kFull, mt);
    sc = __reduce_add_sync(kFull, sc);
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
        o[2 * g.K] = m;
        o[2 * g.K + 1] = s;
    }
}

// The top-K buffer's keys for K: kWarpCap in the warp form (K <=
// kWarpMaxK); in the block form a power of two of at least 2K + 256, the
// keys one step adds.
int count_buffer(int K) {
    return K <= kWarpMaxK ? kWarpCap : pow2_at_least(2 * K + kThreads);
}

}  // namespace

extern "C" {

int open_count_max_k() { return kMaxK; }

// Launches the count on `stream`; returns cudaGetLastError() after the
// launch (0 on success). Device pointers: rows i32 [BN, >= Fax] with row
// stride `stride`, zs i32 (or null) with row stride `zstride`, live i32
// [BN] (each row's live prefix, as the gather wrote it), row_spec,
// row_i0, row_i1, row_maxz i32 [R], out i32 [R, 2K + 2]. mode: 0 packed
// keys without a charge tag, 1 packed with one, 2 -pep keys (tags in zs
// when has_z).
int open_count(const void* rows, long long stride, const void* zs,
               long long zstride, const void* live, int BN, int Fax,
               int mode, int has_z, const void* row_spec, const void* row_i0,
               const void* row_i1, const void* row_maxz, int R, int nbcov,
               int K, void* out, void* stream) {
    if (R <= 0) return 0;
    if (K < 1 || K > kMaxK || BN < 1 || Fax < 0 || nbcov < 1)
        return (int)cudaErrorInvalidValue;
    const int cap = count_buffer(K);
    const Args g{(const int*)rows, stride, (const int*)zs, zstride,
                 (const int*)live, BN, Fax, mode, has_z,
                 (const int*)row_spec, (const int*)row_i0,
                 (const int*)row_i1, (const int*)row_maxz, R, nbcov, K, cap,
                 (int*)out};
    const size_t key = sizeof(unsigned long long);
    if (K <= kWarpMaxK) {
        const unsigned blocks = (unsigned)((R + kWarpRows - 1) / kWarpRows);
        open_count_warp_kernel<<<blocks, kWarpRows * 32,
                                 kWarpRows * cap * key,
                                 (cudaStream_t)stream>>>(g);
    } else {
        open_count_block_kernel<<<(unsigned)R, kThreads, cap * key,
                                  (cudaStream_t)stream>>>(g);
    }
    return (int)cudaGetLastError();
}

}  // extern "C"
