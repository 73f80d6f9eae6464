// take_along_axis over a 2-D float32 table, on Hopper: the earlier form, a yardstick.
//
// The port's first K2 (the earlier ops/csrc/take_along_axis.cu), kept unchanged but for the
// name of its C function so that chip_smoke.py can time it beside the kernel that
// replaced it (ops/csrc/take_along_axis.cu, which stages the table on chip).  The port
// never calls it.
//
// Replaces the anonymous Pallas kernel of bench/probe_mosaic_gather.py
// (`bench_gather`, lines 69-92, pallas_call at line 75), which probed Mosaic's
// in-block dynamic gather.  For a (R, L) table `t` and int32 indices `idx` of
// the same shape it computes
//
//     axis 1:  out[r, c] = t[r, idx[r, c]]      (idx in [0, L))
//     axis 0:  out[r, c] = t[idx[r, c], c]      (idx in [0, R))
//
// What bounds it.  Per element the card must read `idx` (4 B) and write `out`
// (4 B); `t` is read once, 4 B per element.  At the probe's 1,048,576-element
// shapes that is 12.6 MB, 3.8 us at 3.35 TB/s; at (8, 1048576) 100.7 MB,
// 30 us.  Below about 5 us the launch itself sets the time.  The random part
// is the reads of `t`: the largest probe table (8 x 1048576, 32 MB) fits the
// 50 MB L2, so after first touch those reads stay on chip.  There is no
// arithmetic: the kernel is bound by bytes.
//
// How the design meets it.  One thread per four consecutive elements of a row
// (the wrapper requires L % 4 == 0, as every probe shape has): one 16-byte
// load of `idx`, four `__ldg` reads of `t` through the read-only path, one
// 16-byte store of `out`, so `idx` and `out` stream fully coalesced.  Offsets
// are 64-bit; `axis` is a run-time argument.  An index outside its range is
// clamped into it, so a corrupt index cannot read outside `t`.
//
// Numerics: a pure copy, bit-equal to the plain PyTorch version.
//
// C interface (loaded with ctypes by protocol_tpu_torch/ops/_build.py):
//     int take_along_axis_ldg(t, idx, out, rows, cols, axis, stream)
// launches on `stream` and returns cudaGetLastError() (0 on success).

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ long long clamp_index(int k, long long n) {
  return min(max(static_cast<long long>(k), 0LL), n - 1);
}

// Output element (r, c).
__device__ __forceinline__ float take_one(const float* __restrict__ t, long long r, long long c,
                                          int k, long long rows, long long cols, int axis) {
  return axis == 1 ? __ldg(t + r * cols + clamp_index(k, cols))
                   : __ldg(t + clamp_index(k, rows) * cols + c);
}

__global__ void __launch_bounds__(kThreads)
take_along_axis_kernel(const float* __restrict__ t, const int4* __restrict__ idx,
                     float4* __restrict__ out, long long n4, long long rows, long long cols,
                     int axis) {
  const long long i = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (i >= n4) return;
  const int4 k = __ldg(idx + i);
  // cols % 4 == 0, so the four elements share one row.
  const long long e = i * 4;
  const long long r = e / cols;
  const long long c = e - r * cols;
  float4 v;
  v.x = take_one(t, r, c, k.x, rows, cols, axis);
  v.y = take_one(t, r, c + 1, k.y, rows, cols, axis);
  v.z = take_one(t, r, c + 2, k.z, rows, cols, axis);
  v.w = take_one(t, r, c + 3, k.w, rows, cols, axis);
  out[i] = v;
}

}  // namespace

extern "C" int take_along_axis_ldg(const void* t, const void* idx, void* out, long long rows,
                               long long cols, long long axis, void* stream) {
  const long long n4 = rows * cols / 4;  // cols % 4 == 0
  if (n4 <= 0) return 0;
  const unsigned int blocks = static_cast<unsigned int>((n4 + kThreads - 1) / kThreads);
  take_along_axis_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(t), static_cast<const int4*>(idx), static_cast<float4*>(out), n4,
      rows, cols, static_cast<int>(axis));
  return static_cast<int>(cudaGetLastError());
}
