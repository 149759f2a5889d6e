// The entry gather of the peak-major searches, hand-written for Hopper
// (sm_90a).
//
// Replaces the XLA programs (no Pallas kernel) of sage_tpu's
// _entries_rows and _entries_flat (sage_tpu/ops/open_search.py:367,
// :423), whose plain version, open_entries_plain (ops/open_search.py), is
// a chain of int64 scatter_add_, cumsum and gathers over [rows, F]. Given
// each window's fragment range (start, len), it writes the row that the
// sort reads: one pseudo-row a (spectrum, covered band) pair, the windows
// w = z * Pk + pk of the pair in order, each window's fragments' peptide
// ids. The row's shape and every element equal the plain version's, so
// the caller picks the same sort as before:
//
// - flat (F columns): entry j of a row belongs to window w(j), the last
//   window whose exclusive prefix of lengths, min(cum0[w], F - 1), is
//   <= j, and reads fragment starts[w] + j - cum0[w] (clamped to the
//   table) when j < the row's total. The plain version builds the same
//   w(j) by a scatter of marks at min(cum0, F - 1) and a cumsum; a row
//   whose total passes F keeps its first F entries, except that entry
//   F - 1 then reads through the last window, as the plain version's
//   clipped marks make it. (Such a row is an overflow that every caller
//   detects from the lengths and redoes.)
// - row-aligned (chunked, Wr x 64 columns): window w owns the 64-entry
//   table rows floor(s / 64) .. ceil(e / 64); slot r of the row belongs to
//   the last window whose exclusive prefix of row counts is <= r, and an
//   entry is kept when r < the total row count, its position lies in
//   [s, e) and its peptide id is >= 0; windows whose rows start past Wr
//   are dropped.
//
// Each element is written in one of two forms. Packed (the row-sort and
// cluster kernels sort it): ((2^25 - pep) << 5) | z, or 2^25 - pep with
// one fragment-charge plane, and INT32_MAX where there is no entry.
// Unpacked (torch.sort sorts it; rows past the kernels' length or
// peptide ids past 25 bits): -pep, or 2^30 where there is no entry, and,
// with Z > 1, the fragment-charge tag w(j) / Pk + 1 of every element in
// a second array. The starts and lengths come in the searches' [B, Z *
// nbcov * Pk] layout (column (z * nbcov + k) * Pk + pk); pseudo-row
// b * nbcov + k reads its windows from there, so no permuted copy is
// made.
//
// What bounds it on an H100: bytes. Each row writes its W elements (the
// tail past its entries too, since the sort reads whole rows) and reads
// its live entries' peptide ids (whole 64-entry rows in the row-aligned
// layout) and its windows' starts and lengths. Design: one block a
// pseudo-row. The block scans its windows' lengths (or row counts) into
// a per-row int64 scratch in device memory, then each thread takes
// elements j = tid, tid + 256, ...: an element past the row's entries is
// written at once, an element inside them finds its window by binary
// search over the scan (L1-resident: a few KB a row) and reads its
// peptide id. Consecutive threads write consecutive elements.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kVRow = 64;
constexpr int kPMax = 1 << 25;
constexpr int kNoPep = 1 << 30;
constexpr int kInt32Max = 0x7fffffff;
constexpr unsigned kFull = 0xffffffffu;

// first w in [0, n) whose key(w) > x, n if none; key non-decreasing
__device__ __forceinline__ int upper(const long long* c, int n,
                                     long long cap, long long x) {
    int lo = 0, len = n;
    while (len > 0) {
        const int half = len >> 1;
        long long v = c[lo + half];
        v = v < cap ? v : cap;
        if (v <= x) {
            lo += half + 1;
            len -= half + 1;
        } else {
            len = half;
        }
    }
    return lo;
}

__global__ void __launch_bounds__(kThreads)
open_entries_kernel(
    const int* __restrict__ pep,     // flat [n_pep]
    long long n_pep,
    const int* __restrict__ starts,  // [B, Z * nbcov * Pk]
    const int* __restrict__ lens,
    int nbcov, int Z, int Pk, int chunked, int Wr, int F,
    int packed,
    long long* scratch,              // [BN, Z * Pk]
    int* __restrict__ keys,          // [BN, W]
    int* __restrict__ ztag) {        // [BN, W] or null
    __shared__ long long warp_tot[kWarps];
    __shared__ long long carry;
    const int tid = threadIdx.x;
    const int lane = tid & 31;
    const int warp = tid >> 5;
    const long long rr = blockIdx.x;
    const long long b = rr / nbcov;
    const int k = (int)(rr - b * nbcov);
    const int Wn = Z * Pk;
    const size_t in_row = (size_t)b * Wn * nbcov;
    // window w = z * Pk + pk of this pseudo-row, in the searches' layout
    auto col = [&](int w) {
        const int z = w / Pk;
        return in_row + ((size_t)z * nbcov + k) * Pk + (w - z * Pk);
    };
    long long* cum = scratch + rr * Wn;

    // the exclusive scan of the windows' lengths (flat) or row counts
    if (tid == 0) carry = 0;
    __syncthreads();
    for (int base = 0; base < Wn; base += kThreads) {
        const int w = base + tid;
        long long v = 0;
        if (w < Wn) {
            const long long l = __ldg(lens + col(w));
            if (!chunked) {
                v = l;
            } else if (l > 0) {
                const long long s = __ldg(starts + col(w));
                v = (s + l + (kVRow - 1)) / kVRow - s / kVRow;
            }
        }
        long long x = v;
        for (int o = 1; o < 32; o <<= 1) {
            const long long y = __shfl_up_sync(kFull, x, o);
            if (lane >= o) x += y;
        }
        if (lane == 31) warp_tot[warp] = x;
        __syncthreads();
        long long off = carry;
        for (int i = 0; i < warp; ++i) off += warp_tot[i];
        if (w < Wn) cum[w] = off + x - v;
        __syncthreads();
        if (tid == kThreads - 1) carry = off + x;
        __syncthreads();
    }
    const long long total = carry;

    const long long W = chunked ? (long long)Wr * kVRow : F;
    int* krow = keys + rr * W;
    int* zrow = ztag ? ztag + rr * W : nullptr;
    const long long n8 = n_pep / kVRow;
    for (long long j = tid; j < W; j += kThreads) {
        if (!chunked) {
            if (packed && j >= total) {
                krow[j] = kInt32Max;
                continue;
            }
            const int w = upper(cum, Wn, F - 1, j) - 1;
            const int zt = (w < 0 ? 0 : (w >= Wn ? Wn - 1 : w)) / Pk + 1;
            int p = -1;
            if (j < total) {
                long long src = __ldg(starts + col(w)) + (j - cum[w]);
                src = src < 0 ? 0 : (src >= n_pep ? n_pep - 1 : src);
                p = __ldg(pep + src);
            }
            if (packed) {
                krow[j] = p < 0 ? kInt32Max
                                : (Z == 1 ? kPMax - p
                                          : ((kPMax - p) << 5) | zt);
            } else {
                krow[j] = p < 0 ? kNoPep : -p;
                if (zrow) zrow[j] = zt;
            }
        } else {
            const long long r = j / kVRow;
            if (packed && r >= total) {
                krow[j] = kInt32Max;
                continue;
            }
            int w = upper(cum, Wn, Wr, r) - 1;
            w = w < 0 ? 0 : (w >= Wn ? Wn - 1 : w);
            const int zt = w / Pk + 1;
            const long long s = __ldg(starts + col(w));
            const long long e = s + __ldg(lens + col(w));
            long long row = s / kVRow + (r - cum[w]);
            row = row < 0 ? 0 : (row >= n8 ? n8 - 1 : row);
            const long long pos = row * kVRow + (j - r * kVRow);
            const int g = __ldg(pep + pos);
            const bool ok = r < total && pos >= s && pos < e && g >= 0;
            if (packed) {
                krow[j] = !ok ? kInt32Max
                              : (Z == 1 ? kPMax - g
                                        : ((kPMax - g) << 5) | zt);
            } else {
                krow[j] = ok ? -g : kNoPep;
                if (zrow) zrow[j] = zt;
            }
        }
    }
}

}  // namespace

extern "C" {

// Launches the gather on `stream`; returns cudaGetLastError() after the
// launch (0 on success). Device pointers: pep i32 [n_pep] (the flat
// fragment-peptide table; a multiple of 64 long when chunked), starts
// and lens i32 [B, Z * nbcov * Pk], scratch i64 [B * nbcov, Z * Pk],
// keys i32 [B * nbcov, W] (W = Wr * 64 when chunked, else F), ztag i32
// of the same shape, or null (packed, or Z == 1).
int open_entries(const void* pep, long long n_pep, const void* starts,
                 const void* lens, int B, int nbcov, int Z, int Pk,
                 int chunked, int Wr, int F, int packed, void* scratch,
                 void* keys, void* ztag, void* stream) {
    const long long BN = (long long)B * nbcov;
    if (BN <= 0) return 0;
    if (Z * Pk <= 0 || BN > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
    open_entries_kernel<<<(unsigned)BN, kThreads, 0, (cudaStream_t)stream>>>(
        (const int*)pep, n_pep, (const int*)starts, (const int*)lens, nbcov,
        Z, Pk, chunked, Wr, F, packed, (long long*)scratch, (int*)keys,
        (int*)ztag);
    return (int)cudaGetLastError();
}

}  // extern "C"
