// The windowed step's bridge, on Hopper: run partials out of the row-local prefix lanes,
// permuted into dst order.
//
// Replaces the jit'd XLA pass `bridge_partials` of protocol_tpu/ops/gather_window.py:1007
// (ROADMAP B3).  It is not a Pallas kernel in the reference; the port's plain version,
// `bridge_partials_plain` in protocol_tpu_torch/ops/gather_window.py, repeats its
// arithmetic.  For every bucket-order run s of the S runs:
//
//     (eh, el) = (hi[seg_end[s]], lo[seg_end[s]])
//     (ph, pl) = (+0.0, +0.0) where s == 0 or seg_first[s], else run s-1's (eh, el)
//     partial[s] = (eh - ph) + (el - pl)
//
// and then out[j] = partial[seg_perm[j]] for every j < S.
//
// Op order is the contract: the partials are bit-identical to the JAX package on the
// CPU, so the kernel must equal the plain version bit for bit.  The three float
// operations are __fsub_rn / __fsub_rn / __fadd_rn in that order, and the source is
// never built with --use_fast_math or -ftz=true (denormals survive as in PyTorch).
//
// What bounds it.  The function must read seg_end (4 B), seg_first (1 B), both lanes at
// each run end (8 B) and seg_perm (4 B), and write out (4 B): 21 B a run, ~347 MB at the
// headline's 16.5M-run capacity, ~0.10 ms at 3.35 TB/s.  Counted in 32-byte sectors the
// lane read lies between that and the lanes' whole 429 MB; the headline's run ends
// cluster and touch 3.1M distinct sectors (198 MB on both lanes), which puts the bound at
// ~0.12 ms.  No arithmetic to speak of: the bound is bytes.
//
// How the design meets it, right before fast.  Two launches on the stream:
//   - pass 1 streams in bucket order, one thread a run: seg_end and seg_first read
//     coalesced, the lanes read at the strictly increasing run ends (neighbouring
//     threads hit neighbouring sectors), the previous run's end taken from the
//     neighbouring lane by a warp shuffle (lane 0 reads it itself), and `partial`
//     written coalesced to an S-float scratch;
//   - pass 2 is the permutation gather out[j] = partial[seg_perm[j]], seg_perm read and
//     out written coalesced, the partial reads random (66 MB of scratch at the headline,
//     against a 50 MB L2).
// Computing each dst-order output from seg_perm[j] directly would cost ~5 random sectors
// an output; the plan's layout (no inverse permutation) stays as the reference has it.
//
// C interface (loaded with ctypes by protocol_tpu_torch/ops/_build.py):
//     int bridge_partials(hi, lo, seg_end, seg_first, seg_perm, partial, out, s, stream)
// with seg_end and seg_perm int32, seg_first one byte a run (0 or 1), `partial` S floats
// of scratch; launches on `stream` and returns cudaGetLastError() (0 on success).

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
run_partials_kernel(const float* __restrict__ hi, const float* __restrict__ lo,
                    const int* __restrict__ seg_end, const unsigned char* __restrict__ seg_first,
                    float* __restrict__ partial, long long s_count) {
  const long long s = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  const int lane = threadIdx.x & 31;
  const bool live = s < s_count;
  float eh = 0.0f, el = 0.0f;
  if (live) {
    const int e = seg_end[s];
    eh = hi[e];
    el = lo[e];
  }
  // Run s-1's end from the neighbouring lane; every lane of the warp takes part.
  float ph = __shfl_up_sync(0xffffffffu, eh, 1);
  float pl = __shfl_up_sync(0xffffffffu, el, 1);
  if (!live) return;
  if (s == 0 || seg_first[s]) {
    ph = 0.0f;
    pl = 0.0f;
  } else if (lane == 0) {
    const int e = seg_end[s - 1];
    ph = hi[e];
    pl = lo[e];
  }
  partial[s] = __fadd_rn(__fsub_rn(eh, ph), __fsub_rn(el, pl));
}

__global__ void __launch_bounds__(kThreads)
permute_kernel(const float* __restrict__ partial, const int* __restrict__ seg_perm,
               float* __restrict__ out, long long s_count) {
  const long long j = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (j < s_count) out[j] = __ldg(partial + seg_perm[j]);
}

}  // namespace

extern "C" int bridge_partials(const void* hi, const void* lo, const void* seg_end,
                               const void* seg_first, const void* seg_perm, void* partial,
                               void* out, long long s, void* stream) {
  if (s <= 0) return 0;
  const auto st = static_cast<cudaStream_t>(stream);
  const auto grid = static_cast<unsigned int>((s + kThreads - 1) / kThreads);
  run_partials_kernel<<<grid, kThreads, 0, st>>>(
      static_cast<const float*>(hi), static_cast<const float*>(lo),
      static_cast<const int*>(seg_end), static_cast<const unsigned char*>(seg_first),
      static_cast<float*>(partial), s);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  permute_kernel<<<grid, kThreads, 0, st>>>(static_cast<const float*>(partial),
                                            static_cast<const int*>(seg_perm),
                                            static_cast<float*>(out), s);
  return static_cast<int>(cudaGetLastError());
}
