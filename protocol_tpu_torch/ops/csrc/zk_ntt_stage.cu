// K11: one radix-2 decimation-in-time butterfly stage of the Fr NTT, on Hopper.
//
// Replaces `protocol_tpu/zk/graft/ntt.py:77` `_stage_fn`: with the n elements cut into
// n / L groups of L = 2 * half, element k < half of a group and its partner k + half
// become (u + t, u - t) mod r, t = x[k + half] * w[k] in the Montgomery domain.  The
// plain version is `protocol_tpu_torch/zk/graft/ntt.py::_stage_plain`.
//
// x is (n, 4) uint64 words of Montgomery Fr, updated in place; tw is the stage's half
// twiddles (half, 4), Montgomery Fr, a slice of the plan tensor `ntt.py` caches on the
// card per (n, root).  One launch a stage, as in the reference; the host bit-reverse
// permutation stays on the host (numpy) before the first stage.
//
// The butterflies are indexed globally, g < n / 2 with group g >> log2(half) and k the low
// bits, so the stage at L = 2 (n / 2 groups of one) and the one at L = n (one group of
// n / 2) fill the card alike: no block is tied to a group.
//
// What bounds it.  A butterfly is one Montgomery multiply (264 32-bit multiply-adds) and
// an add and a subtract; it reads and writes two elements (128 bytes) and reads a twiddle
// (32 bytes, from L2 after the first groups).  As for K10 the integer multiplies and the
// bytes take about as long; each element is read and written once a stage.
#include <cstdint>

#include <cuda_runtime.h>

#include "bn254_field.cuh"

namespace {

__global__ void __launch_bounds__(256) ntt_stage_kernel(uint64_t* __restrict__ x,
                                                        const uint64_t* __restrict__ tw,
                                                        long long butterflies, int log_half) {
    const long long half = 1LL << log_half;
    const long long stride = (long long)gridDim.x * blockDim.x;
    for (long long g = (long long)blockIdx.x * blockDim.x + threadIdx.x; g < butterflies;
         g += stride) {
        long long k = g & (half - 1);
        long long i0 = ((g >> log_half) << (log_half + 1)) + k;
        long long i1 = i0 + half;
        bn254::Fe u = bn254::load(x + 4 * i0);
        bn254::Fe v = bn254::load(x + 4 * i1);
        bn254::Fe w = bn254::load(tw + 4 * k);
        bn254::Fe t = bn254::mont_mul<bn254::FR>(v, w);
        bn254::store(x + 4 * i0, bn254::add<bn254::FR>(u, t));
        bn254::store(x + 4 * i1, bn254::sub<bn254::FR>(u, t));
    }
}

}  // namespace

extern "C" int zk_ntt_stage(uint64_t* x, const uint64_t* tw, long long n, long long half,
                            void* stream) {
    if (n < 2) return 0;
    if (half < 1 || (half & (half - 1)) || (n % (2 * half))) return (int)cudaErrorInvalidValue;
    int log_half = 0;
    while ((1LL << log_half) < half) ++log_half;
    long long butterflies = n / 2;
    long long blocks = (butterflies + 255) / 256;
    int grid = (int)(blocks < 132 * 16 ? blocks : 132 * 16);
    ntt_stage_kernel<<<grid, 256, 0, static_cast<cudaStream_t>(stream)>>>(x, tw, butterflies,
                                                                         log_half);
    return (int)cudaGetLastError();
}
