// The candidate rescore, hand-written for Hopper (sm_90a).
//
// Replaces sage_tpu/ops/search.py:285 rescore_candidate, which has no
// Pallas kernel: XLA fuses it, vmapped over the [n, k] candidate grid,
// into the jitted stage-2 programs. For each item (a candidate's full
// fragment ladders f [S, L] against its row's peaks) and each
// (series s, ion l, fragment charge z) slot it finds the most intense
// in-window peak, then reduces the slots to the seven features of
// score_candidate (scoring.rs:675-793): the matched counts of the N- and
// C-terminal series, the b and y intensity sums and the ppm-error sum,
// and the longest runs of matched ions of each terminus.
//
// Exactness (every output bit-equal to the plain version and to
// sage_tpu). Every f32 op is one IEEE op rounded on its own (__fdiv_rn,
// __fmul_rn, __fadd_rn, __fsub_rn; the build also passes -fmad=false):
// mz = f / (z + 1), and the bounds in tol_bounds_static's order,
// mz + (mz * lo) / s (ppm: s = 1e6, pct: s = 100) or mz + lo (da). A
// peak qualifies when pm >= lo && pm <= hi, its intensity is >= 0 and
// z + 1 < maxz; written so, NaN bounds (a -inf slot under ppm) match
// nothing. The match is the qualifying peak of greatest intensity, among
// equal intensities the one of greatest mass (the plain version's
// max-then-max rule; no argmax). An unmatched slot has intensity and
// mass 0 and a ppm term of exactly 0. The three f32 sums run strictly
// in order over t = (s * L + l) * Z + z from 0.0f, one lane each, never
// a tree, a shuffle reduction or an atomic. The Run automaton
// (scoring.rs:771-793) runs verbatim over any-charge matches, series
// then ion, every series of a terminus feeding one run. The matched
// counts are integers, summed in any order.
//
// What bounds it on an H100. The work is the peak compares, two per
// (live slot, peak): n * k * S * L * Pk * (live charges) * 2 f32
// compares, against the card's f32 issue rate (132 SMs x 128 lanes x
// ~1.98 GHz = 33.5 T/s); the bytes are f (n * k * S * L * 4), the peaks
// (n * Pk * 8), maxz and the seven outputs, each moved once, against
// 3.35 TB/s. At the narrow search's shapes (k = 50 items a row, 94 slots,
// a few hundred peaks) the compares bound it by far.
//
// Design (a simple one that is right; making it fast is later work). One
// block per row n: its Pk peaks are loaded once into shared memory as
// (mass, intensity) pairs, 8 bytes a peak, and every item of the row
// reads them there. One warp per item, the block's warps walking over
// the row's items: the lanes cover the item's (s, l) slots, each lane
// loops over the charges in order and over the peaks linearly (all lanes
// read the same peak at once, a broadcast), and writes its slots' three
// terms and its any-charge match flag to the warp's shared scratch in
// iterator order. After __syncwarp, lanes 0-2 run the three sums (the
// b intensity, the y intensity, the ppm term), each one sequential
// chain, and lanes 3-4 the two automata; the matched counts are a warp
// reduction. Charges at or past maxz are skipped: no peak qualifies
// there. Callers with one item a row pass k = 1 and a peak row gathered
// per item.

#include <cuda_runtime.h>

namespace {

constexpr int kMaxWarps = 8;
constexpr unsigned kFull = 0xffffffffu;
constexpr long long kSmemMax = 227LL * 1024;

enum TolKind { kPpm = 0, kPct = 1, kDa = 2 };

__device__ __forceinline__ float bound(int kind, float c, float t) {
    if (kind == kDa) return __fadd_rn(c, t);
    const float s = kind == kPpm ? 1e6f : 100.0f;
    return __fadd_rn(c, __fdiv_rn(__fmul_rn(c, t), s));
}

// Shared memory: the row's peaks (8 bytes each, rounded up to 16), then
// per warp the three term columns (3 * T floats) and one flag byte a
// slot (rounded up to 16).
__host__ __device__ __forceinline__ long long peak_bytes(int Pk) {
    return (8LL * Pk + 15) / 16 * 16;
}

__host__ __device__ __forceinline__ long long warp_bytes(int S, int L,
                                                        int Z) {
    const long long SL = (long long)S * L;
    return 12LL * SL * Z + (SL + 15) / 16 * 16;
}

int warps_for(int k, int S, int L, int Pk, int Z) {
    int w = k < kMaxWarps ? (k < 1 ? 1 : k) : kMaxWarps;
    while (w > 1 && peak_bytes(Pk) + w * warp_bytes(S, L, Z) > kSmemMax) --w;
    return w;
}

__global__ void rescore_kernel(
    const float* __restrict__ f, const float* __restrict__ pkm,
    const float* __restrict__ pki, const int* __restrict__ maxz, int k,
    int S, int L, int Pk, int Z, int nterm, int kind, float tlo, float thi,
    int* __restrict__ mb, int* __restrict__ my, float* __restrict__ sb,
    float* __restrict__ sy, float* __restrict__ pp, int* __restrict__ lb,
    int* __restrict__ ly) {
    extern __shared__ float4 smem4[];
    unsigned char* smem = reinterpret_cast<unsigned char*>(smem4);
    float2* peaks = reinterpret_cast<float2*>(smem);
    const int SL = S * L;
    const int T = SL * Z;
    const int row = blockIdx.x;
    const int warp = threadIdx.x >> 5;
    const int lane = threadIdx.x & 31;
    const int nwarps = blockDim.x >> 5;

    const size_t pbase = (size_t)row * Pk;
    for (int p = threadIdx.x; p < Pk; p += blockDim.x)
        peaks[p] = make_float2(pkm[pbase + p], pki[pbase + p]);
    __syncthreads();

    float* term = reinterpret_cast<float*>(
        smem + peak_bytes(Pk) + warp * warp_bytes(S, L, Z));
    float* term_b = term;          // b intensity, [T]
    float* term_y = term + T;      // y intensity, [T]
    float* term_p = term + 2 * T;  // ppm term, [T]
    unsigned char* flag = reinterpret_cast<unsigned char*>(term + 3 * T);

    for (int item = warp; item < k; item += nwarps) {
        const size_t it = (size_t)row * k + item;
        const float* fi = f + it * SL;
        const int zmax = maxz[it];
        int cb = 0, cy = 0;
        for (int j = lane; j < SL; j += 32) {
            const bool nt = (nterm >> (j / L)) & 1;
            const float fv = fi[j];
            bool any = false;
            for (int z = 0; z < Z; ++z) {
                const float mz = __fdiv_rn(fv, (float)(z + 1));
                const float lo = bound(kind, mz, tlo);
                const float hi = bound(kind, mz, thi);
                float bi = -1.0f, bm = 0.0f;
                if (z + 1 < zmax) {
                    for (int p = 0; p < Pk; ++p) {
                        const float2 q = peaks[p];
                        if (q.x >= lo && q.x <= hi && q.y >= 0.0f &&
                            (q.y > bi || (q.y == bi && q.x > bm))) {
                            bi = q.y;
                            bm = q.x;
                        }
                    }
                }
                const bool m = bi >= 0.0f;
                float ppm = 0.0f;
                if (m) {
                    const float d = fabsf(__fsub_rn(mz, bm));
                    const float den = __fadd_rn(mz, bm);
                    ppm = __fdiv_rn(__fmul_rn(__fmul_rn(bi, d), 2e6f),
                                    den == 0.0f ? 1.0f : den);
                } else {
                    bi = 0.0f;
                }
                const int t = j * Z + z;
                term_b[t] = nt ? bi : 0.0f;
                term_y[t] = nt ? 0.0f : bi;
                term_p[t] = ppm;
                any |= m;
                cb += (m && nt);
                cy += (m && !nt);
            }
            flag[j] = any;
        }
        cb = __reduce_add_sync(kFull, cb);
        cy = __reduce_add_sync(kFull, cy);
        __syncwarp();
        if (lane < 3) {
            // one strictly sequential chain a lane
            const float* col = term + lane * T;
            float acc = 0.0f;
            for (int t = 0; t < T; ++t) acc = __fadd_rn(acc, col[t]);
            (lane == 0 ? sb : lane == 1 ? sy : pp)[it] = acc;
            if (lane == 0) {
                mb[it] = cb;
                my[it] = cy;
            }
        } else if (lane < 5) {
            // the Run automaton over the terminus's series in order
            const bool want = lane == 3;
            int start = 0, length = 0, last = 0, longest = 0;
            for (int s = 0; s < S; ++s) {
                if ((((nterm >> s) & 1) != 0) != want) continue;
                for (int l = 0; l < L; ++l) {
                    if (!flag[s * L + l] || last == l) continue;
                    if (start + length == l) {
                        ++length;
                    } else {
                        start = l;
                        length = 1;
                    }
                    longest = length > longest ? length : longest;
                    last = l;
                }
            }
            (want ? lb : ly)[it] = longest;
        }
        __syncwarp();
    }
}

}  // namespace

extern "C" {

// Dynamic shared memory the kernel needs for these shapes, in bytes (at
// the warps a block it launches with).
long long rescore_smem_bytes(int k, int S, int L, int Pk, int Z) {
    return peak_bytes(Pk) + warps_for(k, S, L, Pk, Z) * warp_bytes(S, L, Z);
}

// Launches the kernel on `stream`, one block a row; returns
// cudaGetLastError() after the launch (0 on success). Every pointer is a
// device pointer; f is [n, k, S, L], pkm / pki [n, Pk], maxz and the
// outputs [n, k]; bit s of nterm marks series s N-terminal.
int rescore_candidate(const void* f, const void* pkm, const void* pki,
                      const void* maxz, int n, int k, int S, int L, int Pk,
                      int Z, int nterm, int kind, float tlo, float thi,
                      void* mb, void* my, void* sb, void* sy, void* pp,
                      void* lb, void* ly, void* stream) {
    if (n <= 0 || k <= 0) return 0;
    const int warps = warps_for(k, S, L, Pk, Z);
    const long long smem = rescore_smem_bytes(k, S, L, Pk, Z);
    if (smem > kSmemMax) return (int)cudaErrorInvalidValue;
    if (smem > 48 * 1024) {
        cudaError_t e = cudaFuncSetAttribute(
            rescore_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
            (int)smem);
        if (e != cudaSuccess) return (int)e;
    }
    rescore_kernel<<<n, warps * 32, (size_t)smem, (cudaStream_t)stream>>>(
        (const float*)f, (const float*)pkm, (const float*)pki,
        (const int*)maxz, k, S, L, Pk, Z, nterm, kind, tlo, thi, (int*)mb,
        (int*)my, (float*)sb, (float*)sy, (float*)pp, (int*)lb, (int*)ly);
    return (int)cudaGetLastError();
}

}  // extern "C"
