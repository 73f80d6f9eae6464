// K11: the radix-2 decimation-in-time NTT over Fr, on Hopper: every butterfly stage in
// two launches (one where n <= 2^log_tile).
//
// Replaces `protocol_tpu/zk/graft/ntt.py:77` `_stage_fn` (one launch a stage there), with
// the host bit-reverse before it (`ntt.py:129`) and the conversions and 1/n scale around
// it (`ntt.py:100` `_scale_fn`, `to_mont`, `from_mont`).  x is (n, 4) uint64 words of
// canonical Fr in natural order; y gets the transform, canonical, in natural order.  The
// plain version is `protocol_tpu_torch/zk/graft/ntt.py::_ntt_plain`, the same passes over
// the plain stages `_stage_plain`.
//
// The data never enters the Montgomery domain: the plan's twiddles are Montgomery forms
// w * 2^256, so mont_mul(v, w * 2^256) = v * w, and the one canonical result of every
// operation makes the output bit-identical to the reference's, which converts in and out.
// The inverse's 1/n is a Montgomery multiply by (1/n) * 2^256 in the last pass's store.
// The first stage's twiddle is 1: its butterflies add and subtract only.
//
// What bounds it.  A whole NTT needs a Montgomery multiply (264 32-bit multiply-adds) for
// each butterfly whose twiddle is not 1, (n / 2) log2 n - (n - 1), and the inverse's n
// scale products (`ntt.py::needed_multiplies`): 0.0155 ms forward at n = 2^17 at the SM's
// integer rate, above its bytes (input and output once, 64 n, and the n - 1 twiddles,
// 32 (n - 1): 0.0038 ms).  This kernel skips the first stage's multiplies only.  The
// first form ran one launch a stage, each reading and writing all n elements, and the
// launches' issue on the host set its pace when they ran in a row.
//
// The design: a pass holds a tile of 2^q * C elements of y in shared memory (four planes
// of 64-bit words, so neighbouring threads touch neighbouring words), runs q stages
// there, __syncthreads between stages, and writes the tile back.
//   pass 1: stages 1 .. q = min(log2 n, log_tile) on contiguous tiles of the bit-reversed
//           order, read straight from x at the bit-reversed indices (each element is one
//           32-byte sector), written to y;
//   pass 2 (and further passes where log2 n > 2 log_tile): the next q stages, on the
//           elements whose indices differ only in those stages' bits: 2^q rows of C
//           neighbouring columns, each row C * 32 contiguous bytes; in place on y.
#include <cstdint>

#include <cuda_runtime.h>

#include "bn254_field.cuh"

namespace {

constexpr int MAX_THREADS = 512;

using bn254::Fe;

__device__ __forceinline__ Fe tile_load(const uint64_t* sm, int plane, int e) {
    Fe r;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
        const uint64_t word = sm[k * plane + e];
        r.v[2 * k] = (uint32_t)word;
        r.v[2 * k + 1] = (uint32_t)(word >> 32);
    }
    return r;
}

__device__ __forceinline__ void tile_store(uint64_t* sm, int plane, int e, const Fe& a) {
#pragma unroll
    for (int k = 0; k < 4; ++k) sm[k * plane + e] = (uint64_t)a.v[2 * k] | ((uint64_t)a.v[2 * k + 1] << 32);
}

// Stages s0 + 1 .. s0 + q of the NTT on one tile: element e = r * C + cc of the tile (C =
// 2^log_c) is global index (hb << (s0 + q)) | (r << s0) | (c0 + cc).  src is read at the
// bit-reversed index where bitrev is set; src and dst may be the same array.
__global__ void __launch_bounds__(MAX_THREADS) ntt_pass_kernel(
    const uint64_t* src, uint64_t* dst, const uint64_t* __restrict__ plan,
    const uint64_t* __restrict__ scale, int log_n, int s0, int q, int log_c, int bitrev) {
    extern __shared__ uint64_t sm[];
    const int plane = 1 << (q + log_c);
    const int cmask = (1 << log_c) - 1;
    const long long hb = (long long)blockIdx.x >> (s0 - log_c);
    const long long c0 = ((long long)blockIdx.x & ((1LL << (s0 - log_c)) - 1)) << log_c;
    const long long base = (hb << (s0 + q)) | c0;
    for (int e = threadIdx.x; e < plane; e += blockDim.x) {
        const long long i = base | ((long long)(e >> log_c) << s0) | (e & cmask);
        const long long from = bitrev ? (long long)(__brevll((unsigned long long)i) >> (64 - log_n)) : i;
        const ulonglong2* p = reinterpret_cast<const ulonglong2*>(src + 4 * from);
        const ulonglong2 a = p[0], b = p[1];
        sm[e] = a.x;
        sm[plane + e] = a.y;
        sm[2 * plane + e] = b.x;
        sm[3 * plane + e] = b.y;
    }
    __syncthreads();
    const int butterflies = plane >> 1;
    for (int j = 0; j < q; ++j) {
        const long long h = 1LL << (s0 + j);  // the stage's half, globally
        const int low = (1 << j) - 1;
        for (int b = threadIdx.x; b < butterflies; b += blockDim.x) {
            const int rb = b >> log_c;
            const int r0 = ((rb >> j) << (j + 1)) | (rb & low);
            const int e0 = (r0 << log_c) | (b & cmask);
            const int e1 = e0 + (1 << (j + log_c));
            const Fe u = tile_load(sm, plane, e0);
            Fe t = tile_load(sm, plane, e1);
            if (h > 1) {
                const long long k = ((long long)(r0 & low) << s0) | (c0 + (b & cmask));
                t = bn254::mont_mul<bn254::FR>(t, bn254::load(plan + 4 * (h - 1 + k)));
            }
            tile_store(sm, plane, e0, bn254::add<bn254::FR>(u, t));
            tile_store(sm, plane, e1, bn254::sub<bn254::FR>(u, t));
        }
        __syncthreads();
    }
    for (int e = threadIdx.x; e < plane; e += blockDim.x) {
        const long long i = base | ((long long)(e >> log_c) << s0) | (e & cmask);
        Fe x = tile_load(sm, plane, e);
        if (scale != nullptr) x = bn254::mont_mul<bn254::FR>(x, bn254::load(scale));
        ulonglong2* p = reinterpret_cast<ulonglong2*>(dst + 4 * i);
        p[0] = make_ulonglong2((uint64_t)x.v[0] | ((uint64_t)x.v[1] << 32),
                               (uint64_t)x.v[2] | ((uint64_t)x.v[3] << 32));
        p[1] = make_ulonglong2((uint64_t)x.v[4] | ((uint64_t)x.v[5] << 32),
                               (uint64_t)x.v[6] | ((uint64_t)x.v[7] << 32));
    }
}

}  // namespace

// x, y: (n, 4) words, n a power of two, not the same array; plan: the (n - 1, 4) Montgomery
// twiddles, stage L's from row L/2 - 1; scale: one Montgomery word (the inverse's 1/n) or
// null.  Runs the passes in order, at most max_passes of them (the scale only in the last
// pass of the whole NTT); log_tile: log2 of the elements a block holds (<= 12: 128 KB).
extern "C" int zk_ntt(const uint64_t* x, uint64_t* y, const uint64_t* plan, const uint64_t* scale,
                      long long n, long long log_tile, long long max_passes, void* stream) {
    if (n < 2 || (n & (n - 1)) || log_tile < 1 || log_tile > 12) return (int)cudaErrorInvalidValue;
    int log_n = 0;
    while ((1LL << log_n) < n) ++log_n;
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    int s0 = 0;
    for (long long pass = 0; s0 < log_n && pass < max_passes; ++pass) {
        const int q = (int)(log_n - s0 < log_tile ? log_n - s0 : log_tile);
        const int log_c = (int)(log_tile - q < s0 ? log_tile - q : s0);
        const int plane = 1 << (q + log_c);
        const int smem = 32 * plane;
        if (smem > 48 * 1024) {  // the current device's limit, raised at each such launch
            cudaError_t err = cudaFuncSetAttribute(
                ntt_pass_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
            if (err != cudaSuccess) return (int)err;
        }
        const int threads = plane / 2 < MAX_THREADS ? plane / 2 : MAX_THREADS;
        const bool last = s0 + q == log_n;
        ntt_pass_kernel<<<(unsigned)(n / plane), threads, smem, s>>>(
            pass == 0 ? x : y, y, plan, last ? scale : nullptr, log_n, s0, q, log_c, pass == 0);
        cudaError_t err = cudaGetLastError();
        if (err != cudaSuccess) return (int)err;
        s0 += q;
    }
    return 0;
}
