// The window-range search of the peak-major searches, hand-written for
// Hopper (sm_90a). One kernel source, two entry points.
//
// Replaces the XLA programs (no Pallas kernel) of sage_tpu's
// _device_ranges / _device_ranges_flat (sage_tpu/ops/open_search.py:112,
// :246) and bounded_count's binary search (sage_tpu/ops/narrow_banded.py
// :74), whose plain versions are torch chains: _probe (a three-level
// decimated rank probe, ops/open_search.py) and _bounded_search (nstep
// rounds of gather, compare and where, ops/narrow_banded.py). For every
// (slot, fragment charge z, peak) the tolerance window of the peak's mass
// times z + 1 is a contiguous range of one peptide band's m/z-sorted
// fragment masses; each thread finds its element's range by binary search.
//
// Bounds. Each thread computes c = m * (z + 1) and the bounds of
// tol_bounds_static in its op order, one IEEE op at a time (__fmul_rn,
// __fdiv_rn, __fadd_rn; the build passes -fmad=false): c + (c * lo) / s
// for ppm (s = 1e6) and pct (s = 100), c + lo for da. So a mass lying
// exactly on a bound lands where the plain version puts it, and no
// [slots, peaks] bound tensor is materialised.
//
// The open form (peak_ranges_open) equals the plain probe and the host's
// np.searchsorted: the start is the band's flat offset plus the count of
// band masses < lo, the length the count of masses <= hi minus that (at
// least 0). A slot that is not valid, a non-finite bound, and a window
// that misses the band's mass span (hi < first or lo > last) give
// (0, 0), the host's shortcut; every other window has finite bounds, so
// the two searches are plain lower / upper bounds over the band's
// ascending masses (read from the band-aligned 64-lane table, flat, at
// row_off * 64). The plain probe compares against a 3.0e38 clamp of
// non-finite bounds and clips its ranks with the band's length; both
// only touch elements this form already zeroes or never exceeds.
//
// The banded form (peak_ranges_banded) runs the plain version's bounded
// search literally: nstep rounds of mid = (lo + hi) / 2, v = mz[clamp(mid,
// 0, n - 1)], pred = (v < bound, or v <= bound for the high end) && lo <
// hi, lo = pred ? mid + 1 : lo, hi = pred ? hi : min(mid, hi), over the
// covered band's segment [seg_lo, seg_hi). Once lo == hi nothing moves,
// so the loop stops there. A NaN bound compares false and leaves lo at
// seg_lo. The start is that lo for every element, NaN and +-inf bounds
// included; only the length is masked to 0 where a bound is not finite.
//
// What bounds it on an H100. Each element reads one peak mass and writes
// two i32; each search is about log2(band length) dependent loads (16 in
// a banded segment of 2048 peptides, 21 in an open band of 1.5 M
// fragments), most of them from L2 and L1 (the first levels of every
// search share a few lines). So the work is latency: the design keeps
// many searches in flight (one element a thread, 256 threads a block,
// thousands of blocks) and nothing else.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

enum TolKind { kPpm = 0, kPct = 1, kDa = 2 };

__device__ __forceinline__ float bound(int kind, float c, float t) {
    if (kind == kDa) return __fadd_rn(c, t);
    const float s = kind == kPpm ? 1e6f : 100.0f;
    return __fadd_rn(c, __fdiv_rn(__fmul_rn(c, t), s));
}

__device__ __forceinline__ bool finite(float x) {
    return fabsf(x) <= 3.402823466e38f;  // false for +-inf and NaN
}

// count of the n ascending masses a[0, n) that are < x (strict) or <= x
__device__ __forceinline__ long long rank(const float* __restrict__ a,
                                          long long n, float x,
                                          bool strict) {
    long long lo = 0, len = n;
    while (len > 0) {
        const long long half = len >> 1;
        const float v = __ldg(a + lo + half);
        if (strict ? (v < x) : (v <= x)) {
            lo += half + 1;
            len -= half + 1;
        } else {
            len = half;
        }
    }
    return lo;
}

// Element e = ((s * Zb) + zi) * Pk + pk of the open form: slot s of NS,
// output row s / nsub, column (zi * nsub + s % nsub) * Pk + pk.
__global__ void __launch_bounds__(kThreads)
peak_ranges_open_kernel(
    const float* __restrict__ masses,     // [B, Pk]
    int B, int Pk,
    const long long* __restrict__ spec,   // [NS] or null: s / nsub
    const long long* __restrict__ band,   // [NS]
    const bool* __restrict__ valid,       // [NS]
    long long NS, int nsub, int Zb, int nb,
    const float* __restrict__ mz,         // flat band-aligned masses
    const long long* __restrict__ row_off,  // [nb] 64-lane rows
    const long long* __restrict__ blen,     // [nb]
    const long long* __restrict__ boff,     // [nb] flat offsets
    const float* __restrict__ bfirst,       // [nb]
    const float* __restrict__ blast,        // [nb]
    int kind, float tlo, float thi,
    int* __restrict__ st, int* __restrict__ ln) {
    const long long e = (long long)blockIdx.x * kThreads + threadIdx.x;
    const long long total = NS * Zb * Pk;
    if (e >= total) return;
    const int pk = (int)(e % Pk);
    const long long t = e / Pk;
    const int zi = (int)(t % Zb);
    const long long s = t / Zb;
    const long long orow = s / nsub;
    const int k = (int)(s - orow * nsub);
    const size_t out = (size_t)orow * ((size_t)Zb * nsub * Pk)
                       + ((size_t)zi * nsub + k) * Pk + pk;
    int o_st = 0, o_ln = 0;
    if (valid[s]) {
        long long b = band[s];
        b = b < 0 ? 0 : (b >= nb ? nb - 1 : b);
        long long sp = spec ? spec[s] : orow;
        sp = sp < 0 ? 0 : (sp >= B ? B - 1 : sp);
        const float m = __ldg(masses + (size_t)sp * Pk + pk);
        const float c = zi == 0 ? m : __fmul_rn(m, (float)(zi + 1));
        const float lo = bound(kind, c, tlo);
        const float hi = bound(kind, c, thi);
        if (finite(lo) && finite(hi) && hi >= __ldg(bfirst + b)
            && lo <= __ldg(blast + b)) {
            const float* a = mz + (size_t)__ldg(row_off + b) * 64;
            const long long n = __ldg(blen + b);
            const long long r0 = rank(a, n, lo, true);
            const long long r1 = rank(a, n, hi, false);
            o_st = (int)(__ldg(boff + b) + r0);
            o_ln = (int)(r1 > r0 ? r1 - r0 : 0);
        }
    }
    st[out] = o_st;
    ln[out] = o_ln;
}

// the plain version's bounded search, literally (see the note above)
__device__ __forceinline__ long long bounded(const float* __restrict__ mz,
                                             long long n1, long long lo,
                                             long long hi, float x,
                                             bool inclusive, int nstep) {
    for (int i = 0; i < nstep && lo < hi; ++i) {
        const long long mid = (lo + hi) / 2;
        const long long c = mid < 0 ? 0 : (mid > n1 ? n1 : mid);
        const float v = __ldg(mz + c);
        if (inclusive ? (v <= x) : (v < x)) {
            lo = mid + 1;
        } else {
            hi = mid < hi ? mid : hi;
        }
    }
    return lo;
}

// Element e = ((b * Zb + zi) * nbcov + k) * Pk + pk of the banded form:
// output [B, Zb * nbcov * Pk], column (zi * nbcov + k) * Pk + pk.
__global__ void __launch_bounds__(kThreads)
peak_ranges_banded_kernel(
    const float* __restrict__ masses,  // [B, Pk]
    int B, int Pk,
    const int* __restrict__ bb,        // [B, nbcov, 2]
    int nbcov, int Zb,
    const float* __restrict__ mz, long long n_mz, int nstep,
    int kind, float tlo, float thi,
    int* __restrict__ st, int* __restrict__ ln) {
    const long long e = (long long)blockIdx.x * kThreads + threadIdx.x;
    const long long total = (long long)B * Zb * nbcov * Pk;
    if (e >= total) return;
    const int pk = (int)(e % Pk);
    long long t = e / Pk;
    const int k = (int)(t % nbcov);
    t /= nbcov;
    const int zi = (int)(t % Zb);
    const long long b = t / Zb;
    const float m = __ldg(masses + (size_t)b * Pk + pk);
    const float c = zi == 0 ? m : __fmul_rn(m, (float)(zi + 1));
    const float lo = bound(kind, c, tlo);
    const float hi = bound(kind, c, thi);
    const int* seg = bb + ((size_t)b * nbcov + k) * 2;
    const long long s0 = __ldg(seg), s1 = __ldg(seg + 1);
    const long long left = bounded(mz, n_mz - 1, s0, s1, lo, false, nstep);
    const long long right = bounded(mz, n_mz - 1, s0, s1, hi, true, nstep);
    // e's layout is the output's: b, then zi, then k, then pk
    st[e] = (int)left;
    ln[e] = (finite(lo) && finite(hi) && right > left) ? (int)(right - left)
                                                       : 0;
}

unsigned blocks_for(long long n) {
    return (unsigned)((n + kThreads - 1) / kThreads);
}

}  // namespace

extern "C" {

// The open form; returns cudaGetLastError() after the launch (0 on
// success). Device pointers: masses [B, Pk] f32; spec (or null), band
// i64 and valid bool [NS]; mz the band-aligned flat masses; row_off,
// blen, boff i64 and bfirst, blast f32 [nb]; st, ln i32 [NS / nsub,
// Zb * nsub * Pk].
int peak_ranges_open(const void* masses, int B, int Pk, const void* spec,
                     const void* band, const void* valid, long long NS,
                     int nsub, int Zb, int nb, const void* mz,
                     const void* row_off, const void* blen, const void* boff,
                     const void* bfirst, const void* blast, int kind,
                     float tlo, float thi, void* st, void* ln,
                     void* stream) {
    const long long n = NS * Zb * Pk;
    if (n <= 0) return 0;
    const cudaStream_t st_ = (cudaStream_t)stream;
    peak_ranges_open_kernel<<<blocks_for(n), kThreads, 0, st_>>>(
        (const float*)masses, B, Pk, (const long long*)spec,
        (const long long*)band, (const bool*)valid, NS, nsub, Zb, nb,
        (const float*)mz, (const long long*)row_off, (const long long*)blen,
        (const long long*)boff, (const float*)bfirst, (const float*)blast,
        kind, tlo, thi, (int*)st, (int*)ln);
    return (int)cudaGetLastError();
}

// The banded form; device pointers: masses [B, Pk] f32, bb i32
// [B, nbcov, 2] (each covered band's segment [lo, hi)), mz f32 [n_mz]
// the (band, m/z)-sorted masses; st, ln i32 [B, Zb * nbcov * Pk].
int peak_ranges_banded(const void* masses, int B, int Pk, const void* bb,
                       int nbcov, int Zb, const void* mz, long long n_mz,
                       int nstep, int kind, float tlo, float thi, void* st,
                       void* ln, void* stream) {
    const long long n = (long long)B * Zb * nbcov * Pk;
    if (n <= 0) return 0;
    const cudaStream_t st_ = (cudaStream_t)stream;
    peak_ranges_banded_kernel<<<blocks_for(n), kThreads, 0, st_>>>(
        (const float*)masses, B, Pk, (const int*)bb, nbcov, Zb,
        (const float*)mz, n_mz, nstep, kind, tlo, thi, (int*)st, (int*)ln);
    return (int)cudaGetLastError();
}

}  // extern "C"
