// The candidate rescore, hand-written for Hopper (sm_90a).
//
// Replaces sage_tpu/ops/search.py:285 rescore_candidate, which has no
// Pallas kernel: XLA fuses it, vmapped over the [n, k] candidate grid,
// into the jitted stage-2 programs. For each live item (r, j) -- peptide
// pep[r, j]'s full fragment ladders lad[pep] [S, L] against the peaks of
// row spec[r] -- and each (series s, ion l, fragment charge z) slot it
// finds the most intense in-window peak, then reduces the slots to the
// seven features of score_candidate (scoring.rs:675-793): the matched
// counts of the N- and C-terminal series, the b and y intensity sums and
// the ppm-error sum, and the longest runs of matched ions of each
// terminus. Items j >= live[r] of row r are dead: all seven outputs 0.
//
// Exactness (every output bit-equal to the plain version and to
// sage_tpu). Every f32 op is one IEEE op rounded on its own (__fdiv_rn,
// __fmul_rn, __fadd_rn, __fsub_rn; the build also passes -fmad=false):
// mz = f / (z + 1) (f / 1 is f, so z = 0 skips the division), and the
// bounds in tol_bounds_static's order, mz + (mz * lo) / s (ppm: s = 1e6,
// pct: s = 100) or mz + lo (da). A peak qualifies when pm >= lo &&
// pm <= hi, its intensity is >= 0 and z + 1 < maxz. The match is the
// qualifying peak of greatest intensity, among equal intensities the one
// of greatest mass (the plain version's max-then-max rule). An unmatched
// slot has intensity and mass 0 and a ppm term of exactly 0. The three
// f32 sums run strictly in order over t = (s * L + l) * Z + z from +0.0f,
// never a tree, a shuffle reduction or an atomic; they add the matched
// terms only. That is exact: every skipped term is +-0.0f, and x + +-0 is
// x for every x other than a zero, while +0 + +-0 is +0 (round to
// nearest), so a chain that starts at +0.0f never holds -0 and never
// changes by a skipped term. The Run automaton (scoring.rs:771-793) runs
// verbatim once a matched (slot, charge) in that order, each on its
// terminus's state. That equals the reference's one step a slot with any
// matched charge: a slot's charges are adjacent in the order, so its
// second and later matched charges meet last == l and are skipped. The
// matched counts are popcounts of ballots, integers.
//
// The peak range. With a row's masses ascending (+inf pads last, no NaN)
// both predicates are monotone over the row, equal masses included:
// pm[p] >= lo is false then true, and !(pm[p] <= hi) is false then true.
// So the qualifying masses are exactly [a, b), with a the first p where
// pm[p] >= lo and b the first p >= a where !(pm[p] <= hi): every p < a
// has pm < lo, every p >= b has pm > hi (or b = a), and every p in
// [a, b) has lo <= pm <= hi. A binary search finds a; the scan walks
// from a and stops at the first !(pm[p] <= hi), which is b. A NaN lo (a
// -inf slot under ppm or pct) makes pm >= lo false everywhere, so a = Pk
// and the range is empty, as the compares give; a NaN hi stops the walk
// at a; and lo > hi stops it at a too. The predicates are written in
// exactly these forms. A -inf slot can match only a -inf peak (under da;
// ppm and pct give a NaN lo), and ascending rows hold -inf peaks first,
// so -inf slots are skipped unless the tolerance is da and the row's
// first mass is -inf. The wrapper states the precondition and the tests
// check every caller; it is not checked here.
//
// Dead items. The fused programs (ops/search.py run_inner) pass
// live = cnt_s, the count of merge slots whose stage-1 count is > 0, a
// prefix of each spectrum row. sage_tpu rescores peptide 0 at the slots
// past it; here all seven fields there (mb, my, summed_b, summed_y,
// ppm_sum, longest_b, longest_y) are 0 instead. No output reads them:
// the selection key masks them (ok = mask & ...), so they sort after
// every live slot; the packed rows7 hold them only past n_ok, and the
// finalize reads min(n_ok, Ksel) rows a spectrum; items7 holds them past
// cnt_s, and the fallback reads rows [s K0, s K0 + cnt_s) only. The
// FeatureTable and every file stay sage_tpu's; only the packed device
// buffer differs at those positions.
//
// What bounds it on an H100. The work is a binary search a live
// (slot, charge), about log2(Pk) f32 compares, plus the range's peaks
// and the one that ends it; the bytes are the live items' ladder rows
// (S * L * 4 each), the rows' peaks (Pk * 8), pep, maxz, spec and live,
// and the seven outputs, each moved once, against 3.35 TB/s. At the
// narrow search's shapes the bytes bound it: a few hundred bytes an item
// against a few hundred compares. What the kernel spends beyond that:
// each (slot, charge) is a chain of dependent steps (two IEEE divisions
// for the bounds, a load a search step), a lane idles where an item has
// fewer than 32 pairs left, and the tail is sequential over an item's
// matched pairs (the three chains and the automata cannot be split).
//
// Design. The launch covers live items only. A block of 8 warps takes G
// consecutive rows (G * k about 64 item slots: G = 64 at k = 1, one row
// at k >= 64); warp 0 scans the rows' live counts into shared memory,
// the block writes the dead items' zeros, and each warp walks the
// block's live items, one item at a time. For an item the warp reads its
// ladder row (coalesced, 32 slots a load) and compacts the slots that
// can match (not -inf) into a per-warp list of slot indices in shared
// memory, in slot order; the lanes then take the item's (slot, charge)
// pairs, 32 at a time in t order, each lane one pair: its bounds, the
// binary search and the range scan. The peaks are read by row
// index through the read-only path (L1): a row is hot after the first
// search of the first item on it, a block's items may lie on different
// rows (k = 1), no staging barrier is needed, and nothing bounds Pk (a
// shared-memory copy of the row would). After each round the warp
// ballots the matched pairs and walks them in lane order, all lanes
// together (warp-uniform, no divergence): each pair's intensity, ppm
// term and ion index come by shuffle from its lane, and feed the three
// chains and the automaton of its terminus. Lane 0 writes the outputs.

#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
// item slots (rows x k) a block covers: G = max(1, kItemSlots / k)
constexpr int kItemSlots = 64;
constexpr unsigned kFull = 0xffffffffu;
constexpr long long kSmemMax = 227LL * 1024;

enum TolKind { kPpm = 0, kPct = 1, kDa = 2 };

__device__ __forceinline__ float bound(int kind, float c, float t) {
    if (kind == kDa) return __fadd_rn(c, t);
    const float s = kind == kPpm ? 1e6f : 100.0f;
    return __fadd_rn(c, __fdiv_rn(__fmul_rn(c, t), s));
}

// first p in [0, n) with pm[p] >= x, n if none (a NaN x: n)
__device__ __forceinline__ int first_ge(const float* __restrict__ pm, int n,
                                        float x) {
    int a = 0;
    int len = n;
    while (len > 0) {
        const int half = len >> 1;
        if (__ldg(pm + a + half) >= x) {
            len = half;
        } else {
            a += half + 1;
            len -= half + 1;
        }
    }
    return a;
}

// The Run automaton of one terminus (scoring.rs:771-793), one step
struct Run {
    int start = 0, length = 0, last = 0, longest = 0;
    __device__ __forceinline__ void step(int l) {
        if (last == l) return;
        if (start + length == l) {
            ++length;
        } else {
            start = l;
            length = 1;
        }
        longest = length > longest ? length : longest;
        last = l;
    }
};

// Per-warp scratch: one 16-bit slot index per ladder slot (S * L of
// them), rounded up to 16 bytes.
__host__ __device__ __forceinline__ long long warp_bytes(int S, int L) {
    return (2LL * S * L + 15) / 16 * 16;
}

__host__ __device__ __forceinline__ int rows_a_block(int k) {
    return k >= kItemSlots ? 1 : kItemSlots / k;
}

__global__ void __launch_bounds__(kThreads)
rescore_kernel(const float* __restrict__ lad,   // [P, S, L]
               const int* __restrict__ pep,     // [n, k]
               const int* __restrict__ spec,    // [n]
               const float* __restrict__ pkm,   // [B, Pk]
               const float* __restrict__ pki,   // [B, Pk]
               const int* __restrict__ maxz,    // [n, k]
               const int* __restrict__ live,    // [n] or null: all live
               int n, int k, int P, int B, int S, int L, int Pk, int Z,
               int nterm, int kind, float tlo, float thi,
               int* __restrict__ mb, int* __restrict__ my,
               float* __restrict__ sb, float* __restrict__ sy,
               float* __restrict__ pp, int* __restrict__ lb,
               int* __restrict__ ly) {
    extern __shared__ float4 smem4[];
    __shared__ int pre[kItemSlots + 1];  // live items before each row
    const int SL = S * L;
    const int warp = threadIdx.x >> 5;
    const int lane = threadIdx.x & 31;
    const unsigned below = (1u << lane) - 1u;
    unsigned short* slots = reinterpret_cast<unsigned short*>(
        reinterpret_cast<unsigned char*>(smem4) + warp * warp_bytes(S, L));

    const int G = rows_a_block(k);
    const long long r0 = (long long)blockIdx.x * G;
    const int g = (int)min((long long)G, n - r0);
    if (warp == 0) {
        // inclusive scan of the g <= 64 rows' live counts, two per lane
        int c[2];
        for (int h = 0; h < 2; ++h) {
            const int t = lane + 32 * h;
            int v = 0;
            if (t < g) v = live ? min(max(live[r0 + t], 0), k) : k;
            for (int o = 1; o < 32; o <<= 1) {
                const int u = __shfl_up_sync(kFull, v, o);
                if (lane >= o) v += u;
            }
            c[h] = v;
        }
        c[1] += __shfl_sync(kFull, c[0], 31);
        if (lane == 0) pre[0] = 0;
        if (lane < g) pre[lane + 1] = c[0];
        if (lane + 32 < g) pre[lane + 33] = c[1];
    }
    __syncthreads();

    // the dead items' zeros
    for (int e = threadIdx.x; e < g * k; e += kThreads) {
        const int t = e / k;
        const int j = e - t * k;
        if (j >= pre[t + 1] - pre[t]) {
            const size_t it = (size_t)r0 * k + e;
            mb[it] = 0;
            my[it] = 0;
            sb[it] = 0.0f;
            sy[it] = 0.0f;
            pp[it] = 0.0f;
            lb[it] = 0;
            ly[it] = 0;
        }
    }

    const int total = pre[g];
    for (int q = warp; q < total; q += kWarps) {
        // the row t holding live item q: pre[t] <= q < pre[t + 1]
        int t = 0;
        for (int len = g; len > 1;) {
            const int half = len >> 1;
            if (pre[t + half] <= q) {
                t += half;
                len -= half;
            } else {
                len = half;
            }
        }
        const long long r = r0 + t;
        const size_t it = (size_t)r * k + (q - pre[t]);
        const int p = min(max(pep[it], 0), P - 1);
        const int row = min(max(spec[r], 0), B - 1);
        const float* lrow = lad + (size_t)p * SL;
        const float* pm = pkm + (size_t)row * Pk;
        const float* pi = pki + (size_t)row * Pk;
        const int zact = max(0, min(Z, maxz[it] - 1));

        // compact the slots that can match, in slot order
        int nvalid = 0;
        if (zact > 0) {
            const bool ninf = kind == kDa && __ldg(pm) == -__int_as_float(
                                                            0x7f800000);
            for (int base = 0; base < SL; base += 32) {
                const int j = base + lane;
                bool v = false;
                if (j < SL) {
                    const float fv = __ldg(lrow + j);
                    v = fv != -__int_as_float(0x7f800000) || ninf;
                }
                const unsigned bal = __ballot_sync(kFull, v);
                if (v) slots[nvalid + __popc(bal & below)] =
                           (unsigned short)j;
                nvalid += __popc(bal);
            }
        }
        __syncwarp();

        const int npairs = nvalid * zact;
        float acc_b = 0.0f, acc_y = 0.0f, acc_p = 0.0f;
        int cb = 0, cy = 0;
        Run run_b, run_y;
        for (int q0 = 0; q0 < npairs; q0 += 32) {
            const int pq = q0 + lane;
            float bi = -1.0f, bm = 0.0f, ppm = 0.0f;
            int l = 0;
            bool nt = false;
            if (pq < npairs) {
                const int c = pq / zact;
                const int z = pq - c * zact;
                const int j = slots[c];
                const int s = j / L;
                l = j - s * L;
                nt = (nterm >> s) & 1;
                const float fv = __ldg(lrow + j);
                const float mz = z == 0 ? fv : __fdiv_rn(fv, (float)(z + 1));
                const float lo = bound(kind, mz, tlo);
                const float hi = bound(kind, mz, thi);
                // the range [a, b): walk from a while pm <= hi, which
                // stops at b (no second search: the walk is the scan)
                for (int x = first_ge(pm, Pk, lo); x < Pk; ++x) {
                    const float xm = __ldg(pm + x);
                    if (!(xm <= hi)) break;
                    const float y = __ldg(pi + x);
                    if (y >= 0.0f && (y > bi || (y == bi && xm > bm))) {
                        bi = y;
                        bm = xm;
                    }
                }
                if (bi >= 0.0f) {
                    const float d = fabsf(__fsub_rn(mz, bm));
                    const float den = __fadd_rn(mz, bm);
                    ppm = __fdiv_rn(__fmul_rn(__fmul_rn(bi, d), 2e6f),
                                    den == 0.0f ? 1.0f : den);
                }
            }
            const bool m = bi >= 0.0f;
            const unsigned mm = __ballot_sync(kFull, m);
            const unsigned mn = __ballot_sync(kFull, m && nt);
            cb += __popc(mn);
            cy += __popc(mm & ~mn);
            // the matched pairs in t order, warp-uniform
            for (unsigned rest = mm; rest; rest &= rest - 1) {
                const int src = __ffs(rest) - 1;
                const float v = __shfl_sync(kFull, bi, src);
                const float w = __shfl_sync(kFull, ppm, src);
                const int ls = __shfl_sync(kFull, l, src);
                if ((mn >> src) & 1) {
                    acc_b = __fadd_rn(acc_b, v);
                    run_b.step(ls);
                } else {
                    acc_y = __fadd_rn(acc_y, v);
                    run_y.step(ls);
                }
                acc_p = __fadd_rn(acc_p, w);
            }
        }
        if (lane == 0) {
            mb[it] = cb;
            my[it] = cy;
            sb[it] = acc_b;
            sy[it] = acc_y;
            pp[it] = acc_p;
            lb[it] = run_b.longest;
            ly[it] = run_y.longest;
        }
        __syncwarp();  // the slot list is free for the next item
    }
}

}  // namespace

extern "C" {

// Dynamic shared memory a block needs, in bytes: the per-warp slot
// lists. It depends on the ladder's S x L only, never on Pk or k.
long long rescore_smem_bytes(int S, int L) {
    return kWarps * warp_bytes(S, L);
}

// Launches the kernel on `stream`; returns cudaGetLastError() after the
// launch (0 on success). Every pointer is a device pointer: lad
// [P, S, L], pep [n, k], spec [n], pkm / pki [B, Pk], maxz [n, k], live
// [n] (or null: every item live) and the outputs [n, k]; bit s of nterm
// marks series s N-terminal.
int rescore_indexed(const void* lad, const void* pep, const void* spec,
                    const void* pkm, const void* pki, const void* maxz,
                    const void* live, int n, int k, int P, int B, int S,
                    int L, int Pk, int Z, int nterm, int kind, float tlo,
                    float thi, void* mb, void* my, void* sb, void* sy,
                    void* pp, void* lb, void* ly, void* stream) {
    if (n <= 0 || k <= 0) return 0;
    const long long smem = rescore_smem_bytes(S, L);
    if (smem > kSmemMax || S * L > 65536) return (int)cudaErrorInvalidValue;
    if (smem > 48 * 1024) {
        cudaError_t e = cudaFuncSetAttribute(
            rescore_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
            (int)smem);
        if (e != cudaSuccess) return (int)e;
    }
    const int G = rows_a_block(k);
    const long long blocks = ((long long)n + G - 1) / G;
    rescore_kernel<<<(unsigned)blocks, kThreads, (size_t)smem,
                     (cudaStream_t)stream>>>(
        (const float*)lad, (const int*)pep, (const int*)spec,
        (const float*)pkm, (const float*)pki, (const int*)maxz,
        (const int*)live, n, k, P, B, S, L, Pk, Z, nterm, kind, tlo, thi,
        (int*)mb, (int*)my, (float*)sb, (float*)sy, (float*)pp, (int*)lb,
        (int*)ly);
    return (int)cudaGetLastError();
}

}  // extern "C"
