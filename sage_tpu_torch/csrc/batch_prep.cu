// The narrow batch's prep, hand-written for Hopper (sm_90a): the padded
// peak block and the query rows' peptide ranges in one launch.
//
// Replaces no TPU kernel. sage_tpu pads a batch's peaks and searches its
// query rows' precursor windows on the host (Scorer._pad_peaks and
// Scorer._expand_rows, sage_tpu/ops/search.py), and so did the port until
// those two steps set the pace of the narrow search's host thread. The
// host keeps what cannot move: one pass over the spectrum objects into
// flat columns, and the windows' f32 bounds (the reference's op order).
// This kernel takes the flat peaks, their offsets and the bounds, and
//
// * scatters the peaks into the device's padded block [2, S, Pk]: plane 0
//   the masses with +inf in the pads, plane 1 the intensities with -1,
//   one output element a thread (a spectrum of n peaks fills columns
//   [0, n) of its row);
// * binary-searches each row's low bound (the count of masses below it)
//   and high bound (the count at or below it) over the first P entries of
//   the ascending peptide masses, one bound a thread: np.searchsorted's
//   left and right sides. A NaN bound counts all P, as numpy orders NaN
//   after every number; +-inf compare as numbers. Only comparisons are
//   made, so no rounding enters.
//
// What bounds it on an H100. The block write is most of the bytes (at the
// narrow cell's 8,192 spectra and Pk 160: 10.5 MB written, 5.9 MB read);
// the searches are latency (log2 P, about 21 dependent loads over 2 M
// masses, mostly from L2). So the search blocks come first in the grid,
// to be in flight while the many short padding blocks stream the block
// out; nothing is staged in shared memory.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

// count of the n ascending, NaN-free a[0, n) that are < x, or <= x
__device__ __forceinline__ int rank(const float* __restrict__ a, int n,
                                    float x, bool right) {
    if (x != x) return n;
    int lo = 0, len = n;
    while (len > 0) {
        const int half = len >> 1;
        const float v = __ldg(a + lo + half);
        if (right ? (v <= x) : (v < x)) {
            lo += half + 1;
            len -= half + 1;
        } else {
            len = half;
        }
    }
    return lo;
}

__global__ void __launch_bounds__(kThreads) batch_prep_kernel(
    const float* __restrict__ masses, const float* __restrict__ intens,
    const int* __restrict__ offs, int S, int Pk,
    const float* __restrict__ lo, const float* __restrict__ hi, int R,
    const float* __restrict__ mono, int P, int search_blocks,
    float* __restrict__ peaks, int* __restrict__ i01) {
    if ((int)blockIdx.x < search_blocks) {
        const int t = (int)blockIdx.x * kThreads + (int)threadIdx.x;
        if (t >= 2 * R) return;
        const bool right = t >= R;
        const float x = right ? __ldg(hi + (t - R)) : __ldg(lo + t);
        i01[t] = rank(mono, P, x, right);
        return;
    }
    const long long n_pad = (long long)S * Pk;
    const long long e =
        (long long)((int)blockIdx.x - search_blocks) * kThreads + threadIdx.x;
    if (e >= n_pad) return;
    const int s = (int)(e / Pk);
    const int j = (int)(e - (long long)s * Pk);
    const int a = __ldg(offs + s);
    float m = __int_as_float(0x7f800000);  // +inf
    float v = -1.0f;
    if (j < __ldg(offs + s + 1) - a) {
        m = __ldg(masses + a + j);
        v = __ldg(intens + a + j);
    }
    peaks[e] = m;
    peaks[n_pad + e] = v;
}

}  // namespace

// masses, intens: f32 [N]; offs: i32 [S + 1]; lo, hi: f32 [R]; mono: f32
// [>= P]; peaks: f32 [2, S, Pk] out; i01: i32 [2, R] out (i0 then i1).
// Launches on `stream`; returns the launch's CUDA error (0 on success).
extern "C" int batch_prep(const float* masses, const float* intens,
                          const int* offs, int S, int Pk, const float* lo,
                          const float* hi, int R, const float* mono, int P,
                          float* peaks, int* i01, cudaStream_t stream) {
    const long long search_blocks = (2LL * R + kThreads - 1) / kThreads;
    const long long pad_blocks = ((long long)S * Pk + kThreads - 1) / kThreads;
    const long long blocks = search_blocks + pad_blocks;
    if (blocks == 0) return 0;
    if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
    batch_prep_kernel<<<(unsigned)blocks, kThreads, 0, stream>>>(
        masses, intens, offs, S, Pk, lo, hi, R, mono, P, (int)search_blocks,
        peaks, i01);
    return (int)cudaGetLastError();
}
