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
//   whose total reaches F keeps its first F entries, except that entry
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
// made. Beside the rows it writes each row's live count, the number of
// its keys that hold an entry: min(total, F) in the flat form when every
// window holds live ids, the kept elements in the row-aligned form. The
// count kernel takes it as the end of a sorted row's live prefix.
//
// What bounds it on an H100: bytes. Each row writes its W elements (the
// tail past its entries too, since the sort reads whole rows) and reads
// its live entries' peptide ids (whole 64-entry rows in the row-aligned
// layout) and its windows' starts and lengths. A window's entries are
// contiguous in the table and in the row, so the work is a segmented
// copy. Design: one block a pseudo-row, in tiles of up to kTile windows.
// - The block scans a tile's lengths (or row counts) into shared memory as
//   a saturating int32 prefix, capped at F - 1 (flat) or Wr (row-aligned):
//   exact, because the prefix is only ever read capped there (a window at
//   or past the cap copies nothing) and the cap is what the plain
//   version's clipped marks apply. Each window's start and length go
//   beside it.
// - The copies: the tile's windows cover one contiguous range of the row's
//   units (elements, or 64-entry row slots when row-aligned), each window
//   [c, c + n) of it with n its length cut at the cap. In slices of up to
//   kUnitTile units, each window writes its index over its own units of
//   an owner map in shared memory (the plain version's marks, each mark
//   spread over its window), then the block's threads take the slice's
//   units in turn: a unit reads its owner, the owner's start and place,
//   and copies fragment start + (unit - place), 4 bytes a thread (flat)
//   or 16 bytes (a row slot is 16 threads), masked to the owner's own
//   [s, e) (two windows can share a table row). No unit searches for its
//   window; loads and stores are coalesced within a window and every
//   unit's loads are independent.
// - The tail past the copies is one constant (the no-entry key, and the
//   tag Z: every window's prefix is at or below such an element, so its
//   window is the last one), written in 16-byte stores as soon as the last
//   tile's scan knows where it starts.
// - Flat overflow (a total at or past F): the copies stop at F - 1 and,
//   after a barrier, one thread writes entry F - 1 through the last
//   window from the exact int64 total.
// The live count is the block's sum of the live keys its threads wrote.
// At 32 registers a thread (the launch bound), 8 blocks fit an SM.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kPer = 4;            // windows a thread scans a pass
constexpr int kTile = 2048;        // windows a tile holds
constexpr int kUnitTile = 4096;    // units an owner map slice holds
constexpr int kVRow = 64;
constexpr int kPMax = 1 << 25;
constexpr int kNoPep = 1 << 30;
constexpr int kInt32Max = 0x7fffffff;
constexpr unsigned kFull = 0xffffffffu;

// a + b capped at cap; a, b <= cap <= 2^31 - 1, so a + b fits unsigned
__device__ __forceinline__ unsigned sat(unsigned a, unsigned b,
                                        unsigned cap) {
    const unsigned s = a + b;
    return s < cap ? s : cap;
}

// fill row[from, to) with v: scalar up to a 16-byte boundary, then int4
__device__ __forceinline__ void fill(int* row, long long from, long long to,
                                     int v) {
    if (from >= to) return;
    const long long mis =
        (long long)((reinterpret_cast<uintptr_t>(row + from) & 15) >> 2);
    long long head = mis ? 4 - mis : 0;
    head = head < to - from ? head : to - from;
    if (threadIdx.x < head) row[from + threadIdx.x] = v;
    const long long a = from + head;
    const long long n4 = (to - a) >> 2;
    int4* q = reinterpret_cast<int4*>(row + a);
    const int4 v4 = make_int4(v, v, v, v);
    for (long long i = threadIdx.x; i < n4; i += kThreads) q[i] = v4;
    const long long t = a + (n4 << 2);
    if (t + threadIdx.x < to) row[t + threadIdx.x] = v;
}

struct Enc {
    int packed, Z;
    // the key of peptide p (< 0: no entry) in fragment-charge plane zt
    __device__ __forceinline__ int key(int p, int zt) const {
        if (packed)
            return p < 0 ? kInt32Max
                         : (Z == 1 ? kPMax - p : ((kPMax - p) << 5) | zt);
        return p < 0 ? kNoPep : -p;
    }
};

__host__ __device__ __forceinline__ int min_int(long long a, long long b) {
    return (int)(a < b ? a : b);
}

__global__ void __launch_bounds__(kThreads, 8)
open_entries_kernel(
    const int* __restrict__ pep,     // flat [n_pep]
    int n_pep,
    const int* __restrict__ starts,  // [B, Z * nbcov * Pk]
    const int* __restrict__ lens,
    int nbcov, int Z, int Pk, int chunked, int Wr, int F,
    int packed,
    int* __restrict__ keys,          // [BN, W]
    int* __restrict__ ztag,          // [BN, W] or null
    int* __restrict__ live_out) {    // [BN]
    extern __shared__ unsigned smem[];
    __shared__ unsigned wsum[2][kWarps];
    __shared__ long long wtot[kWarps];
    __shared__ int live_acc;
    const int tid = threadIdx.x;
    const int lane = tid & 31;
    const int warp = tid >> 5;
    const long long rr = blockIdx.x;
    const long long b = rr / nbcov;
    const int k = (int)(rr - b * nbcov);
    const int Wn = Z * Pk;
    const int tw = Wn < kTile ? Wn : kTile;
    // the tile's capped prefix (tw + 1), starts, lengths and owner map
    unsigned* cum = smem;
    int* st = reinterpret_cast<int*>(cum + tw + 1);
    int* ln = st + tw;
    unsigned short* own = reinterpret_cast<unsigned short*>(ln + tw);
    const size_t in_row = (size_t)b * Wn * nbcov;
    // window w = z * Pk + pk of this pseudo-row, in the searches' layout
    auto col = [=](int w) {
        const int z = w / Pk;
        return in_row + ((size_t)z * nbcov + k) * Pk + (w - z * Pk);
    };
    const unsigned cap = chunked ? (unsigned)Wr : (unsigned)(F - 1);
    const long long W = chunked ? (long long)Wr * kVRow : F;
    int* krow = keys + rr * W;
    int* zrow = ztag ? ztag + rr * W : nullptr;
    const int n8 = n_pep / kVRow;
    const Enc enc{packed, Z};
    if (tid == 0) live_acc = 0;

    unsigned carry = 0;    // capped prefix of the tiles before
    long long exact = 0;   // this thread's windows' values, uncapped
    int nlive = 0;         // live keys this thread wrote
    for (int t0 = 0; t0 < Wn; t0 += kTile) {
        const int tn = Wn - t0 < kTile ? Wn - t0 : kTile;
        // the tile's capped exclusive scan, kThreads * kPer windows a
        // pass, one barrier a pass (the warp sums double-buffered)
        for (int p0 = 0, pass = 0; p0 < tn; p0 += kThreads * kPer, ++pass) {
            unsigned v[kPer];
            unsigned s = 0;
#pragma unroll
            for (int i = 0; i < kPer; ++i) {
                const int w = p0 + tid * kPer + i;
                long long x = 0;
                if (w < tn) {
                    const int l = __ldg(lens + col(t0 + w));
                    const int sw = __ldg(starts + col(t0 + w));
                    st[w] = sw;
                    ln[w] = l;
                    if (!chunked) {
                        x = l;
                    } else if (l > 0) {
                        x = ((long long)sw + l + (kVRow - 1)) / kVRow
                            - sw / kVRow;
                    }
                }
                exact += x;
                v[i] = x < (long long)cap ? (unsigned)x : cap;
                s = sat(s, v[i], cap);
            }
            unsigned x = s;
#pragma unroll
            for (int o = 1; o < 32; o <<= 1) {
                const unsigned y = __shfl_up_sync(kFull, x, o);
                if (lane >= o) x = sat(x, y, cap);
            }
            if (lane == 31) wsum[pass & 1][warp] = x;
            __syncthreads();
            unsigned off = carry, blk = 0;
            for (int i = 0; i < kWarps; ++i) {
                const unsigned y = wsum[pass & 1][i];
                if (i < warp) off = sat(off, y, cap);
                blk = sat(blk, y, cap);
            }
            unsigned run = __shfl_up_sync(kFull, x, 1);
            run = sat(off, lane ? run : 0u, cap);
#pragma unroll
            for (int i = 0; i < kPer; ++i) {
                const int w = p0 + tid * kPer + i;
                if (w < tn) cum[w] = run;
                run = sat(run, v[i], cap);
            }
            carry = sat(carry, blk, cap);
        }
        if (tid == 0) cum[tn] = carry;
        __syncthreads();
        if (t0 + kTile >= Wn) {
            // the last tile: the copies end at carry, the tail starts
            const long long tail = chunked ? (long long)carry * kVRow : carry;
            fill(krow, tail, W, enc.key(-1, Z));
            if (zrow) fill(zrow, tail, W, Z);
        }

        // the tile's units [cum[0], carry), in owner-map slices
        for (unsigned e0 = cum[0]; e0 < carry; e0 += kUnitTile) {
            const unsigned e1 = carry - e0 < kUnitTile ? carry : e0 + kUnitTile;
            for (int w = tid; w < tn; w += kThreads) {
                const unsigned a = cum[w] > e0 ? cum[w] : e0;
                const unsigned c1 = cum[w + 1] < e1 ? cum[w + 1] : e1;
                for (unsigned x = a; x < c1; ++x)
                    own[x - e0] = (unsigned short)w;
            }
            __syncthreads();
            if (!chunked) {
                for (unsigned j = e0 + tid; j < e1; j += kThreads) {
                    const int w = own[j - e0];
                    long long src = (long long)st[w] + (j - cum[w]);
                    src = src < 0 ? 0 : (src >= n_pep ? n_pep - 1 : src);
                    const int pv = __ldg(pep + src);
                    const int zt = Z > 1 ? (t0 + w) / Pk + 1 : 1;
                    krow[j] = enc.key(pv, zt);
                    if (zrow) zrow[j] = zt;
                    nlive += pv >= 0;
                }
            } else {
                // a row slot: 16 threads, 4 entries (16 bytes) each
                const int q4 = (tid & 15) * 4;
                for (unsigned q = e0 + (tid >> 4); q < e1;
                     q += kThreads / 16) {
                    const int w = own[q - e0];
                    const long long s = st[w];
                    const long long e = s + ln[w];
                    long long row = s / kVRow + (q - cum[w]);
                    row = row < 0 ? 0 : (row >= n8 ? n8 - 1 : row);
                    const long long pos = row * kVRow + q4;
                    const int4 g =
                        __ldg(reinterpret_cast<const int4*>(pep + pos));
                    const int zt = Z > 1 ? (t0 + w) / Pk + 1 : 1;
                    const int gv[4] = {g.x, g.y, g.z, g.w};
                    int kv[4];
#pragma unroll
                    for (int i = 0; i < 4; ++i) {
                        const bool ok = pos + i >= s && pos + i < e
                                        && gv[i] >= 0;
                        kv[i] = enc.key(ok ? gv[i] : -1, zt);
                        nlive += ok;
                    }
                    const long long d = (long long)q * kVRow + q4;
                    *reinterpret_cast<int4*>(krow + d) =
                        make_int4(kv[0], kv[1], kv[2], kv[3]);
                    if (zrow)
                        *reinterpret_cast<int4*>(zrow + d) =
                            make_int4(zt, zt, zt, zt);
                }
            }
            // own[] is rewritten for the next slice
            if (e1 < carry) __syncthreads();
        }
        // cum[], st[], ln[] are rewritten by the next tile
        if (t0 + kTile < Wn) __syncthreads();
    }

    // the row's exact total (flat: its entries; the overflow fix-up reads
    // it) and its live count
    for (int o = 16; o > 0; o >>= 1)
        exact += __shfl_down_sync(kFull, exact, o);
    if (lane == 0) wtot[warp] = exact;
    nlive = __reduce_add_sync(kFull, nlive);
    if (lane == 0 && nlive) atomicAdd(&live_acc, nlive);
    __syncthreads();
    if (tid == 0) {
        long long total = 0;
        for (int i = 0; i < kWarps; ++i) total += wtot[i];
        int n = live_acc;
        if (!chunked && total >= F) {
            // entry F - 1 through the last window, as the plain version's
            // clipped marks read it
            const int wl = Wn - 1;
            const long long ll = __ldg(lens + col(wl));
            long long src = __ldg(starts + col(wl)) + (F - 1) - (total - ll);
            src = src < 0 ? 0 : (src >= n_pep ? n_pep - 1 : src);
            const int pv = __ldg(pep + src);
            krow[F - 1] = enc.key(pv, Z);
            if (zrow) zrow[F - 1] = Z;
            n += pv >= 0;
        }
        live_out[rr] = n;
    }
}

}  // namespace

extern "C" {

// Dynamic shared memory the kernel needs, in bytes: one tile's capped
// prefix, starts and lengths (4 bytes each a window, up to kTile windows,
// and one prefix more) and one owner-map slice (2 bytes a unit, up to
// kUnitTile units; a unit is an element, or a row slot when chunked).
long long open_entries_smem_bytes(int Z, int Pk, int units) {
    const int tw = min_int((long long)Z * Pk, kTile);
    const int tu = min_int(units, kUnitTile);
    return 4LL * (3LL * tw + 1) + ((2LL * tu + 15) / 16) * 16;
}

// Launches the gather on `stream`; returns cudaGetLastError() after the
// launch (0 on success). Device pointers: pep i32 [n_pep] (the flat
// fragment-peptide table, 16-byte aligned; a multiple of 64 long when
// chunked), starts and lens i32 [B, Z * nbcov * Pk], keys i32
// [B * nbcov, W] (W = Wr * 64 when chunked, else F), ztag i32 of the same
// shape, or null (packed, or Z == 1), live i32 [B * nbcov].
int open_entries(const void* pep, long long n_pep, const void* starts,
                 const void* lens, int B, int nbcov, int Z, int Pk,
                 int chunked, int Wr, int F, int packed, void* keys,
                 void* ztag, void* live, void* stream) {
    const long long BN = (long long)B * nbcov;
    if (BN <= 0) return 0;
    if (Z * Pk <= 0 || BN > 0x7fffffffLL || n_pep < 1
        || n_pep > 0x7fffffffLL || (chunked ? Wr < 0 : F < 1))
        return (int)cudaErrorInvalidValue;
    // at most 32,772 bytes: no opt-in past 48 KB is needed
    const long long smem = open_entries_smem_bytes(Z, Pk, chunked ? Wr : F);
    open_entries_kernel<<<(unsigned)BN, kThreads, (size_t)smem,
                          (cudaStream_t)stream>>>(
        (const int*)pep, (int)n_pep, (const int*)starts, (const int*)lens,
        nbcov, Z, Pk, chunked, Wr, F, packed, (int*)keys, (int*)ztag,
        (int*)live);
    return (int)cudaGetLastError();
}

}  // extern "C"
