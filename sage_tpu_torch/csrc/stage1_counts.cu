// Stage-1 window counts for the narrow search, hand-written for Hopper
// (sm_90a).
//
// Replaces the TPU kernel sage_tpu/ops/pallas_stage1.py::_kernel. For
// each query row (spectrum x precursor charge x isotope error) it walks
// the row's W-candidate window of the mass-sorted ladder table and, for
// each candidate, counts the in-tolerance (peak x fragment charge x
// fragment) pairs as sum [f >= lo_z] - [f > hi_z]. Candidates outside
// the row's peptide range [i0, i1) count 0. The row's output is
// [counts[0..W), sum(counts), #(counts > 0)], the counts-only layout of
// sage_tpu_torch.ops.search.Scorer._stage1.
//
// Exactness. The bounds are tol_bounds_static in the reference's f32 op
// order, c + (c * lo) / s (ppm: s = 1e6, pct: s = 100) or c + lo (da),
// with c = peak * z, each op rounded on its own (__fmul_rn, __fdiv_rn,
// __fadd_rn; the build also passes -fmad=false). The compares are the
// direct form, for every peak in any order: +inf peak pads give NaN
// (ppm, pct) or +inf (da) bounds and -inf ladder slots fail f >= lo, so
// both contribute 0 exactly as in the plain version. Planes z >= maxz
// have +inf bounds in the plain version and match no finite fragment;
// the kernel skips them, which gives the same counts. Candidates outside
// [i0, i1) are skipped likewise. The peak axis is padded to a multiple
// of 4 with NaN bounds, which no fragment matches.
//
// What bounds it on an H100. The work is the compare count,
// sum over rows of (live candidates) * S * Lc * Pk * (live planes) * 2,
// each an f32 compare, against the card's f32 issue rate (one
// instruction per lane per clock: 132 SMs x 128 lanes x ~1.98 GHz =
// 33.5 T/s, half the data sheet's 67 TFLOP/s, which counts a fused
// multiply-add as two); and the bytes of the ladder windows,
// R * W * S * Lc * 4, against the 3.35 TB/s of device memory. At the
// narrow search's shapes the compares take a few times longer than the
// bytes, so the compares bound it.
//
// Design. One CTA of 256 threads per row (a batch holds thousands of
// rows, enough for 132 SMs). The row's peaks are taken in tiles of up to
// 1024 (kPeakTile): a tile's Z x (up to 1024) bounds are computed into
// shared memory as float4 quads of peaks, at most 32 * Z * 256 bytes, so
// no peak count is too large for a block; every fragment tile of the
// row then runs against that peak tile, its counts added to the
// candidates' (a count is a sum of integers, so the order of the tiles
// does not change it), and the next peak tile follows. A row of up to
// 1024 peaks -- the search's rows, whose Pk is the batch's longest
// spectrum, 150 peaks by default -- is one peak tile and one pass over
// its fragments. The row's live fragments
// -- (candidate, series, slot) flattened over the live candidates only,
// so no lane idles at any S * Lc -- are cut into tiles of 256 x 8; the
// tiles are double-buffered in shared memory with cp.async, so the next
// tile's loads are in flight during the current tile's compares (and
// are streamed again, from L2, for each further peak tile). Each
// thread holds 8 consecutive fragments of the tile in registers, and per
// quad of peaks reads the quad's low and high bounds as two 128-bit
// broadcast loads, which feed 8 x 4 x 2 compares. Each compare is one
// set instruction giving 1.0f or 0.0f (FSET.BF, on the ALU pipe) and one
// f32 add into the fragment's count (FADD, on the FMA pipe, which has
// twice the ALU pipe's lanes); the counts stay exact integers in f32 (at
// most Z x Pk a fragment, far below 2^24). The integer form (0 / -1
// masks and one three-input add) compiles to a compare, a select and an
// add, five ALU instructions a pair, and ran at half the rate on the
// card. A thread's fragments span at most a few candidates: it sums
// each run and adds it to the candidate's count in shared memory (one
// atomic a run). The row's sums are warp reductions (__reduce_add_sync).

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kFR = 8;                    // fragments a thread holds
constexpr int kTile = kThreads * kFR;     // fragments a tile
constexpr int kPeakTile = 1024;           // peaks a tile of bounds
constexpr unsigned kFull = 0xffffffffu;

enum TolKind { kPpm = 0, kPct = 1, kDa = 2 };

__device__ __forceinline__ float bound(int kind, float c, float t) {
    if (kind == kDa) return __fadd_rn(c, t);
    const float s = kind == kPpm ? 1e6f : 100.0f;
    return __fadd_rn(c, __fdiv_rn(__fmul_rn(c, t), s));
}

// cnt + [x >= lo] - [x > hi]: set.*.f32.f32 gives 1.0f for true and
// 0.0f for false (and for NaN operands); the adds are exact on integers
// below 2^24
__device__ __forceinline__ float match(float cnt, float x, float lo,
                                       float hi) {
    float ge, gt;
    asm("set.ge.f32.f32 %0, %1, %2;" : "=f"(ge) : "f"(x), "f"(lo));
    asm("set.gt.f32.f32 %0, %1, %2;" : "=f"(gt) : "f"(x), "f"(hi));
    return __fsub_rn(__fadd_rn(cnt, ge), gt);
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
    const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n"
                 :: "r"(s), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
    asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
    asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// Issue the copies of tile t of the row's live fragments into `buf`.
// Fragment j is slot j % Lc of (candidate, series) row j / Lc, counted
// from the first live candidate's first series: its ladder row is
// `lad0 + (j / Lc) * L`.
__device__ __forceinline__ void stage_tile(float* buf, const float* lad0,
                                           int t, int nfrag, int Lc,
                                           int L) {
    for (int e = threadIdx.x; e < kTile; e += kThreads) {
        const int j = t * kTile + e;
        if (j < nfrag) {
            const int cs = j / Lc;
            cp_async4(buf + e, lad0 + (size_t)cs * L + (j - cs * Lc));
        }
    }
    cp_async_commit();
}

__global__ void __launch_bounds__(kThreads)
stage1_counts_kernel(const float* __restrict__ lad,    // [P_pad, S, L]
                     const float* __restrict__ peaks,  // [B, Pk] masses
                     const int* __restrict__ ints,     // [5, R]
                     int* __restrict__ out,            // [R, W + 2]
                     int R, int P_pad, int S, int L, int Lc, int B, int Pk,
                     int W, int Z, int kind, float tlo, float thi) {
    // quads a plane of a peak tile holds (the last tile may use fewer)
    const int Tq = (min(Pk, kPeakTile) + 3) >> 2;
    extern __shared__ float4 smem4[];
    float4* lo4 = smem4;                               // [Z, Tq]
    float4* hi4 = lo4 + Z * Tq;                        // [Z, Tq]
    float* buf = (float*)(hi4 + Z * Tq);               // [2, kTile]
    int* cand = (int*)(buf + 2 * kTile);               // [W]
    __shared__ int red_m[kWarps];
    __shared__ int red_n[kWarps];

    const int row = blockIdx.x;
    // Out-of-range spectrum indices (padding rows) read the last spectrum,
    // as a clamped gather does; their windows are empty.
    const int spec = min(max(ints[row], 0), B - 1);
    const int p0 = min(max(ints[R + row], 0), P_pad - W);
    const int i0 = ints[2 * R + row];
    const int i1 = ints[3 * R + row];
    const int maxz = ints[4 * R + row];
    const int zact = max(0, min(Z, maxz - 1));  // planes z = 1 .. zact
    // live candidates: window positions [c_lo, c_lo + live)
    const int c_lo = max(i0 - p0, 0);
    const int live = max(min(i1 - p0, W) - c_lo, 0);
    const int SLc = S * Lc;
    const int nfrag = zact > 0 ? live * SLc : 0;
    const int ntiles = (nfrag + kTile - 1) / kTile;
    const float* lad0 = lad + (size_t)(p0 + c_lo) * S * L;

    for (int w = threadIdx.x; w < W; w += kThreads) cand[w] = 0;
    const int ptiles = ntiles > 0 ? (Pk + kPeakTile - 1) / kPeakTile : 0;
    for (int pt = 0; pt < ptiles; ++pt) {
        stage_tile(buf, lad0, 0, nfrag, Lc, L);

        // this peak tile's bounds, NaN past its last peak
        const int pb = pt * kPeakTile;
        const int npk = min(Pk - pb, kPeakTile);
        const int Pk4 = (npk + 3) >> 2;
        const float* pk = peaks + (size_t)spec * Pk + pb;
        float* lo_f = (float*)lo4;
        float* hi_f = (float*)hi4;
        const float qnan = __int_as_float(0x7fc00000);
        for (int j = threadIdx.x; j < zact * Pk4 * 4; j += kThreads) {
            const int zi = j / (Pk4 * 4);
            const int k = j - zi * Pk4 * 4;
            float lo = qnan;
            float hi = qnan;
            if (k < npk) {
                const float c = __fmul_rn(pk[k], (float)(zi + 1));
                lo = bound(kind, c, tlo);
                hi = bound(kind, c, thi);
            }
            lo_f[zi * Tq * 4 + k] = lo;
            hi_f[zi * Tq * 4 + k] = hi;
        }

        for (int t = 0; t < ntiles; ++t) {
            if (t + 1 < ntiles) {
                stage_tile(buf + ((t + 1) & 1) * kTile, lad0, t + 1, nfrag,
                           Lc, L);
                cp_async_wait<1>();
            } else {
                cp_async_wait<0>();
            }
            __syncthreads();  // tile t (and the bounds) visible to all
            const int j0 = t * kTile + threadIdx.x * kFR;
            if (j0 < nfrag) {
                const float4* tb = reinterpret_cast<const float4*>(
                    buf + (t & 1) * kTile + threadIdx.x * kFR);
                float x[kFR];
                float cnt[kFR];
#pragma unroll
                for (int i = 0; i < kFR; i += 4) {
                    const float4 v = tb[i / 4];
                    x[i] = v.x;
                    x[i + 1] = v.y;
                    x[i + 2] = v.z;
                    x[i + 3] = v.w;
                }
#pragma unroll
                for (int i = 0; i < kFR; ++i) {
                    // past the row's last fragment: a slot matching nothing
                    if (j0 + i >= nfrag) x[i] = -__int_as_float(0x7f800000);
                    cnt[i] = 0.0f;
                }
                for (int zi = 0; zi < zact; ++zi) {
                    const float4* lz = lo4 + zi * Tq;
                    const float4* hz = hi4 + zi * Tq;
                    for (int q = 0; q < Pk4; ++q) {
                        const float4 a = lz[q];
                        const float4 b = hz[q];
#pragma unroll
                        for (int i = 0; i < kFR; ++i) {
                            float c = match(cnt[i], x[i], a.x, b.x);
                            c = match(c, x[i], a.y, b.y);
                            c = match(c, x[i], a.z, b.z);
                            cnt[i] = match(c, x[i], a.w, b.w);
                        }
                    }
                }
                // runs of one candidate: fragments [c SLc, (c + 1) SLc)
                int c = j0 / SLc;
                int next = (c + 1) * SLc;
                int run = 0;
#pragma unroll
                for (int i = 0; i < kFR; ++i) {
                    if (j0 + i < nfrag) {
                        if (j0 + i >= next) {
                            if (run != 0) atomicAdd(&cand[c_lo + c], run);
                            run = 0;
                            ++c;
                            next += SLc;
                        }
                        run += (int)cnt[i];
                    }
                }
                if (run != 0) atomicAdd(&cand[c_lo + c], run);
            }
            __syncthreads();  // buffer t & 1 (and the bounds) free again
        }
    }
    __syncthreads();

    const int warp = threadIdx.x >> 5;
    const int lane = threadIdx.x & 31;
    int* orow = out + (size_t)row * (W + 2);
    int m = 0;
    int nz = 0;
    for (int w = threadIdx.x; w < W; w += kThreads) {
        const int v = cand[w];
        orow[w] = v;
        m += v;
        nz += v > 0;
    }
    m = __reduce_add_sync(kFull, m);
    nz = __reduce_add_sync(kFull, nz);
    if (lane == 0) {
        red_m[warp] = m;
        red_n[warp] = nz;
    }
    __syncthreads();
    if (threadIdx.x == 0) {
        int ms = 0;
        int ns = 0;
        for (int i = 0; i < kWarps; ++i) {
            ms += red_m[i];
            ns += red_n[i];
        }
        orow[W] = ms;
        orow[W + 1] = ns;
    }
}

}  // namespace

extern "C" {

// Dynamic shared memory the kernel needs for these shapes, in bytes: one
// peak tile's bounds (Pk counts up to kPeakTile peaks only), the two
// fragment buffers and the W candidate counts.
long long stage1_counts_smem_bytes(int W, int Pk, int Z) {
    const long long Tq = ((Pk < kPeakTile ? Pk : kPeakTile) + 3) / 4;
    return 32LL * Z * Tq + 8LL * kTile + 4LL * W;
}

// Launches the kernel on `stream`; returns cudaGetLastError() after the
// launch (0 on success). Every pointer is a device pointer.
int stage1_counts(const void* lad, const void* peaks, const void* ints,
                  void* out, int R, int P_pad, int S, int L, int Lc, int B,
                  int Pk, int W, int Z, int kind, float tlo, float thi,
                  void* stream) {
    if (R <= 0) return 0;
    const long long smem = stage1_counts_smem_bytes(W, Pk, Z);
    if (smem > 48 * 1024) {
        cudaError_t e = cudaFuncSetAttribute(
            stage1_counts_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
            (int)smem);
        if (e != cudaSuccess) return (int)e;
    }
    stage1_counts_kernel<<<R, kThreads, (size_t)smem,
                           (cudaStream_t)stream>>>(
        (const float*)lad, (const float*)peaks, (const int*)ints, (int*)out,
        R, P_pad, S, L, Lc, B, Pk, W, Z, kind, tlo, thi);
    return (int)cudaGetLastError();
}

}  // extern "C"
