// LSD radix sort of long i32 rows across a thread-block cluster,
// hand-written for Hopper (sm_90a).
//
// Replaces sage_tpu/ops/pallas_sort.py::_finish_kernel and the
// hierarchical sort around it (_hier_sort: the row's blocks sorted by
// _sort_kernel, then per merge level a flip pass and cross passes outside
// any kernel and the in-block merge kernel). A TPU core's VMEM held at
// most 2^14 keys, so a longer row had to be sorted in blocks and merged
// over several round trips through device memory. On an H100 a row of up
// to 2^17 keys fits whole in the shared memory of one cluster of at most
// 8 CTAs, whose CTAs read and write each other's shared memory
// (distributed shared memory, DSMEM): cluster_sort_kernel sorts each row
// in one launch, reading every key from device memory once and writing
// it once.
//
// What bounds it on an H100. The least work is one read and one write of
// every key (8 bytes a key at 3.35 TB/s); at the open search's and the
// banded stage 1's rows the bytes are the larger bound. Those rows hold
// mostly INT32_MAX entries (the count cores' invalid entries: 94% of
// phase 16's 65,536-key rows), which are never ranked: the passes touch
// only the real keys, and the INT32_MAX tail is written without being
// read again. What holds it back is latency, not bytes: a CTA loads,
// compacts, sorts and stores in turn, with one CTA an SM at phase 16's
// rows (160 KiB of shared memory), so the SM's loads and stores do not
// overlap its passes; at most about 30 clusters are resident; and a
// row's passes are a chain of barriers over a few thousand keys in one
// CTA (PERF.md, section 6).
//
// Design. One cluster of C CTAs (C <= 8, the portable cluster size; by
// default a CTA takes 2^14 keys, so C = 4 at 2^16 keys, which measured
// faster than 5 or 8) owns one row; the row is cut into chunks of G keys
// (G <= 256) dealt to the CTAs in turn (chunk j to CTA j mod C), so that
// the real keys, which the count cores pack at the front of a row, spread
// over the CTAs. Each CTA:
//   1. loads its chunks into registers, eight 16-byte loads a thread in
//      flight (4-byte loads where the row or chunk is not 16-byte
//      aligned), and appends its real (not INT32_MAX) keys to its buffer
//      at offsets taken with one shared atomic a warp and round, in no
//      particular order: the first pass needs no stability. It keeps the
//      count, OR and AND of its real keys;
//   2. after a cluster barrier, reads all C counts, ORs and ANDs through
//      DSMEM: the row's real-key count N and the bits that vary over its
//      real keys. The passes cover only the span of varying bits, in
//      9-bit digits of the sign-flipped keys (so that unsigned order is
//      i32 order), lowest first; a digit with no varying bit is skipped.
//      Phase 16's keys vary over about 18 bits: two passes, not three.
//   3. When the row's N keys fit one buffer (the open search's and the
//      banded stage 1's rows, always at the default C), every CTA copies
//      its keys into CTA 0's other buffer; the others write the INT32_MAX
//      tail and leave, and CTA 0 runs the passes alone with block
//      barriers (measured faster than passes over the cluster). Otherwise
//      the passes run over the whole cluster, S2 = ceil(N / C) keys a CTA
//      (position q lives in CTA q / S2 at q mod S2).
// Each pass:
//   a. count: each warp walks its contiguous share of the keys, 32 at a
//      time; __match_any_sync groups equal digits and the group's lowest
//      lane adds its size to the warp's 512-bin histogram;
//   b. per digit (a thread each), the exclusive scan over warps and the
//      CTA's total, published; barrier (of the cluster when it runs the
//      passes);
//   c. each digit's first position in the row: the digits below it over
//      the whole row plus the same digit in the CTAs of lower rank (their
//      totals read through DSMEM);
//   d. scatter: the warps walk their keys again in order; each group's
//      leader takes its digit's next position and advances it, each lane
//      adds its rank among the group's lower lanes, and the key is stored
//      into its owner's other buffer (through DSMEM in cluster mode).
//      Keys of one digit keep their order (CTAs, warps, rounds and lanes
//      in order): every pass is stable, so equal keys end equal;
//   e. barrier; the buffers swap.
// Finally the sorted keys are written from the CTAs that own them and the
// INT32_MAX tail, positions N .. F - 1, in equal shares, with 16-byte
// stores (when no pass ran, the real keys are all one value). Keys are
// plain int32: every correct sort gives one output, so the result is
// bit-equal to torch.sort and to the plain version
// (ops/pallas_sort.py::cluster_sort_plain).
//
// Shared memory: two buffers of ceil(F / (C G)) G keys and the warps'
// 512-bin histograms (32 KiB): 160 KiB at F = 2^16, C = 4 and at
// F = 2^17, C = 8 (one CTA an SM).

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kBits = 9;
constexpr int kBins = 1 << kBits;
constexpr int kBinWarps = kBins / 32;  // the warps that scan the digits
constexpr int kMaxCluster = 8;
constexpr int kVec = 8;  // 16-byte loads a thread keeps in flight
constexpr unsigned kFull = 0xffffffffu;
constexpr unsigned kSign = 0x80000000u;
constexpr unsigned kMax = 0x7fffffffu;  // INT32_MAX: not ranked

static_assert(kBins <= kThreads && kWarps <= 32, "a thread per digit");

// Share i of `parts` of the row's INT32_MAX tail, positions N .. F - 1 of
// `dst`, 16-byte stores where aligned
__device__ void fill_tail(int* dst, int F, int N, int parts, int i,
                          int tid) {
    const int P = (F - N + parts - 1) / parts;
    const int t0 = N + i * P;
    const int t1 = min(F, t0 + P);
    if (t0 >= t1) return;
    // the first 16-byte boundary at or after t0
    const int a =
        min(t1, t0 + (int)(((16 - ((uintptr_t)(dst + t0) & 15)) & 15) >> 2));
    const bool al = ((uintptr_t)dst & 3) == 0;
    const int b = al ? a + ((t1 - a) & ~3) : a;
    const int4 m = make_int4((int)kMax, (int)kMax, (int)kMax, (int)kMax);
    for (int q = t0 + tid; q < a; q += kThreads) dst[q] = (int)kMax;
    for (int q = a + 4 * tid; q < b; q += 4 * kThreads)
        *reinterpret_cast<int4*>(dst + q) = m;
    for (int q = b + tid; q < t1; q += kThreads) dst[q] = (int)kMax;
}

// barrier of the block (the passes in CTA 0 alone) or of the cluster
__device__ __forceinline__ void pass_sync(const cg::cluster_group& cluster,
                                          bool local) {
    if (local) {
        __syncthreads();
    } else {
        cluster.sync();
    }
}

__global__ void __launch_bounds__(kThreads, 2)
cluster_sort_kernel(const int* __restrict__ in, int* __restrict__ out, int F,
                    int G) {
    cg::cluster_group cluster = cg::this_cluster();
    const int C = (int)cluster.num_blocks();
    const int r = (int)cluster.block_rank();
    const long long row = blockIdx.x / C;
    const int tid = threadIdx.x;
    const int warp = tid >> 5;
    const int lane = tid & 31;
    const unsigned lt = (1u << lane) - 1u;

    // my chunks: local chunk k is the row's chunk k C + r
    const int nchunks = (F + G - 1) / G;
    const int cap = (nchunks + C - 1) / C * G;  // keys a buffer holds
    const int mine = r < nchunks ? (nchunks - 1 - r) / C + 1 : 0;
    int n = mine * G;  // keys I load
    if (mine > 0 && (nchunks - 1) % C == r) n -= nchunks * G - F;

    extern __shared__ unsigned smem[];
    unsigned* cur = smem;        // my real keys
    unsigned* nxt = smem + cap;  // the exchange buffer
    int* hist = (int*)(smem + 2 * cap);  // [kWarps, kBins]
    __shared__ int tot[kBins];     // my digit totals (read by the cluster)
    __shared__ int wtot[kBinWarps];  // per-warp sums of the totals' scan
    __shared__ unsigned red[3];    // my count, OR, AND (read by the cluster)
    __shared__ unsigned glob[4];   // the row's, and the keys of lower ranks
    if (tid == 0) {
        red[0] = 0;
        red[1] = 0;
        red[2] = kFull;
    }
    __syncthreads();

    // 1. load into registers; append the real keys to cur
    const int* src = in + row * F;
    const bool vec = (G & 3) == 0 && (F & 3) == 0 &&
                     ((uintptr_t)in & 15) == 0;
    unsigned k_or = 0, k_and = kFull;
    for (int i0 = 0; i0 < n; i0 += kThreads * 4 * kVec) {
        unsigned k[kVec][4];
#pragma unroll
        for (int v = 0; v < kVec; ++v) {
            const int i = i0 + (v * kThreads + tid) * 4;
            if (vec) {
                int4 q = make_int4((int)kMax, (int)kMax, (int)kMax, (int)kMax);
                if (i < n) {
                    const int c = i / G;
                    q = *reinterpret_cast<const int4*>(
                        src + (c * C + r) * G + (i - c * G));
                }
                k[v][0] = (unsigned)q.x;
                k[v][1] = (unsigned)q.y;
                k[v][2] = (unsigned)q.z;
                k[v][3] = (unsigned)q.w;
            } else {
#pragma unroll
                for (int j = 0; j < 4; ++j) {
                    const int c = (i + j) / G;
                    k[v][j] = i + j < n
                                  ? (unsigned)src[(c * C + r) * G +
                                                  (i + j - c * G)]
                                  : kMax;
                }
            }
        }
#pragma unroll
        for (int v = 0; v < kVec; ++v) {
            unsigned b[4];
            int cnt = 0;
#pragma unroll
            for (int j = 0; j < 4; ++j) {
                const bool real = k[v][j] != kMax;
                if (real) {
                    k_or |= k[v][j];
                    k_and &= k[v][j];
                }
                b[j] = __ballot_sync(kFull, real);
                cnt += __popc(b[j]);
            }
            if (cnt == 0) continue;  // warp-uniform
            int at = 0;
            if (lane == 0) at = atomicAdd((int*)&red[0], cnt);
            at = __shfl_sync(kFull, at, 0);
#pragma unroll
            for (int j = 0; j < 4; ++j) {
                if (k[v][j] != kMax) cur[at + __popc(b[j] & lt)] = k[v][j];
                at += __popc(b[j]);
            }
        }
    }
    k_or = __reduce_or_sync(kFull, k_or);
    k_and = __reduce_and_sync(kFull, k_and);
    if (lane == 0) {
        atomicOr(&red[1], k_or);
        atomicAnd(&red[2], k_and);
    }
    cluster.sync();  // every CTA's count, OR and AND, and its keys in cur

    // 2. the row's count, OR and AND, and the real keys of lower ranks
    if (warp == 0) {
        unsigned c = 0, o = 0, a = kFull;
        if (lane < C) {
            const unsigned* rr = cluster.map_shared_rank(red, lane);
            c = rr[0];
            o = rr[1];
            a = rr[2];
        }
        const unsigned below = __reduce_add_sync(kFull, lane < r ? c : 0u);
        c = __reduce_add_sync(kFull, c);
        o = __reduce_or_sync(kFull, o);
        a = __reduce_and_sync(kFull, a);
        if (lane == 0) {
            glob[0] = c;
            glob[1] = o;
            glob[2] = a;
            glob[3] = below;
        }
    }
    __syncthreads();
    const int N = (int)glob[0];
    const unsigned vary = N > 1 ? glob[1] ^ glob[2] : 0u;
    int lim = (int)red[0];  // my keys in cur

    // 3. few real keys: CTA 0 gathers them and sorts alone
    const bool local = vary != 0 && N <= cap;  // row-uniform
    if (local) {
        unsigned* d0 = cluster.map_shared_rank(nxt, 0);
        const int below = (int)glob[3];
        for (int q = tid; q < lim; q += kThreads) d0[below + q] = cur[q];
        cluster.sync();  // CTA 0 holds the row's real keys in nxt
        if (r != 0) {
            // CTA 0 sorts; the others write the tail
            fill_tail(out + row * F, F, N, C - 1, r - 1, tid);
            return;
        }
        unsigned* t = cur;
        cur = nxt;
        nxt = t;
        lim = N;
    }
    const int S2 = local ? max(1, N) : max(1, (N + C - 1) / C);  // owned
    const int lo = vary ? __ffs(vary) - 1 : 32;   // the varying bits' span
    const int hi = vary ? 31 - __clz(vary) : -1;
    bool ran = false;

    for (int shift = lo; shift <= hi; shift += kBits) {
        if (((vary >> shift) & (kBins - 1)) == 0) continue;  // row-uniform
        ran = true;
        const int seg = ((lim + kWarps - 1) / kWarps + 31) & ~31;
        const int q0 = warp * seg;
        const int q1 = min(lim, q0 + seg);
        int* h = hist + warp * kBins;
        for (int d = lane; d < kBins; d += 32) h[d] = 0;
        __syncwarp();
        // a. count
        for (int p = q0 + lane; p - lane < q1; p += 32) {
            const bool real = p < q1;
            const unsigned d =
                real ? ((cur[p] ^ kSign) >> shift) & (kBins - 1) : kBins;
            const unsigned peers = __match_any_sync(kFull, d);
            if (real && lane == __ffs(peers) - 1)
                atomicAdd(&h[d], __popc(peers));
        }
        __syncthreads();
        // b. per digit (a thread each), the exclusive scan over warps and
        // the CTA's total
        const bool dig = tid < kBins;
        if (dig) {
            int run = 0;
#pragma unroll
            for (int w = 0; w < kWarps; ++w) {
                const int c = hist[w * kBins + tid];
                hist[w * kBins + tid] = run;
                run += c;
            }
            tot[tid] = run;
        }
        pass_sync(cluster, local);  // every CTA's digit totals
        // c. each digit's first position: all CTAs' lower digits, then
        // this digit in the CTAs of lower rank
        int pre = 0, all = 0, incl = 0;
        if (dig) {
            if (local) {
                all = tot[tid];
            } else {
                int v[kMaxCluster];
#pragma unroll
                for (int c = 0; c < kMaxCluster; ++c)
                    v[c] = c < C ? cluster.map_shared_rank(tot, c)[tid] : 0;
#pragma unroll
                for (int c = 0; c < kMaxCluster; ++c) {
                    if (c < r) pre += v[c];
                    all += v[c];
                }
            }
            incl = all;
#pragma unroll
            for (int off = 1; off < 32; off <<= 1) {
                const int y = __shfl_up_sync(kFull, incl, off);
                if (lane >= off) incl += y;
            }
            if (lane == 31) wtot[warp] = incl;
        }
        __syncthreads();
        if (dig) {
            int base = incl - all + pre;
            for (int w = 0; w < warp; ++w) base += wtot[w];
#pragma unroll
            for (int w = 0; w < kWarps; ++w) hist[w * kBins + tid] += base;
        }
        __syncthreads();
        // d. scatter into the owners' buffers, in order
        for (int p = q0 + lane; p - lane < q1; p += 32) {
            const bool real = p < q1;
            const unsigned k = real ? cur[p] : 0u;
            const unsigned d =
                real ? ((k ^ kSign) >> shift) & (kBins - 1) : kBins;
            const unsigned peers = __match_any_sync(kFull, d);
            const int leader = __ffs(peers) - 1;
            int pos = 0;
            if (real && lane == leader) {
                pos = h[d];
                h[d] = pos + __popc(peers);
            }
            pos = __shfl_sync(kFull, pos, leader);
            if (real) {
                const int q = pos + __popc(peers & lt);
                if (local) {
                    nxt[q] = k;
                } else {
                    const int o = q / S2;
                    cluster.map_shared_rank(nxt, o)[q - o * S2] = k;
                }
            }
            __syncwarp();
        }
        pass_sync(cluster, local);  // e. every key in its owner's buffer
        unsigned* t = cur;
        cur = nxt;
        nxt = t;
        lim = min(S2, max(0, N - r * S2));
    }

    // 4. write the sorted keys I own (every real key is glob[1] when no
    // pass ran) and my share of the INT32_MAX tail
    int* dst = out + row * F;
    const int o0 = r * S2;
    const int own = min(S2, max(0, N - o0));
    const unsigned one = glob[1];
    for (int q = tid; q < own; q += kThreads)
        dst[o0 + q] = (int)(ran ? cur[q] : one);
    if (!local || C == 1) fill_tail(dst, F, N, C, r, tid);
    // no CTA may leave while another can still read its `red`
    if (!ran) cluster.sync();
}

size_t smem_bytes(int F, int C, int G) {
    const int nchunks = (F + G - 1) / G;
    const long long cap = (long long)(nchunks + C - 1) / C * G;
    return (size_t)(4 * (2 * cap + (long long)kWarps * kBins));
}

cudaLaunchConfig_t config(int rows, int C, size_t smem, cudaStream_t stream,
                          cudaLaunchAttribute* attr) {
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3((unsigned)rows * (unsigned)C, 1, 1);
    cfg.blockDim = dim3(kThreads, 1, 1);
    cfg.dynamicSmemBytes = smem;
    cfg.stream = stream;
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = (unsigned)C;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    return cfg;
}

int prepare(int F, int C, int G, size_t* smem) {
    if (C < 1 || C > kMaxCluster || G < 1 || F < 1)
        return (int)cudaErrorInvalidValue;
    *smem = smem_bytes(F, C, G);
    return (int)cudaFuncSetAttribute(
        cluster_sort_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)*smem);
}

}  // namespace

extern "C" {

// Sorts each F-key row of `in` ascending into `out` (rows * F int32),
// one cluster of C CTAs a row, the row dealt to them in chunks of G keys.
// Returns cudaGetLastError() after the launch (0 on success).
int cluster_sort(const void* in, void* out, int rows, int F, int C, int G,
                 void* stream) {
    if (rows <= 0 || F <= 0) return 0;
    size_t smem = 0;
    const int e = prepare(F, C, G, &smem);
    if (e != 0) return e;
    cudaLaunchAttribute attr[1];
    cudaLaunchConfig_t cfg = config(rows, C, smem, (cudaStream_t)stream, attr);
    const cudaError_t le = cudaLaunchKernelEx(
        &cfg, cluster_sort_kernel, (const int*)in, (int*)out, F, G);
    if (le != cudaSuccess) return (int)le;
    return (int)cudaGetLastError();
}

// cudaOccupancyMaxActiveClusters for a launch of `rows` rows of F keys at
// cluster size C and chunk G (written to *clusters), and the dynamic
// shared memory a CTA takes (*smem). Returns the CUDA error (0 on
// success).
int cluster_sort_occupancy(int rows, int F, int C, int G, int* clusters,
                           int* smem) {
    size_t bytes = 0;
    const int e = prepare(F, C, G, &bytes);
    if (e != 0) return e;
    *smem = (int)bytes;
    cudaLaunchAttribute attr[1];
    cudaLaunchConfig_t cfg = config(rows, C, bytes, 0, attr);
    return (int)cudaOccupancyMaxActiveClusters(clusters, cluster_sort_kernel,
                                               &cfg);
}

}  // extern "C"
