// Region-table windowed gather, on Hopper.
//
// Replaces the Pallas kernel `_kernel` launched by `gather_region` in
// bench/probe_fused_primitives.py (kernel body lines 93-106, pallas_call at
// line 123): the windowed gather of protocol_tpu/ops/gather_window.py without
// the weight, over a table cut into 256 KB regions instead of one resident
// score table.  The table is (n_regions * 512, 128) float32, 65,536 entries a
// region; the slots are (n_regions * 512, 128) as well, viewed as rows of 1024
// slots, 64 rows a region.  Row b reads inside one 1024-entry window, number
// wid[b] in [0, 64), of its region b / 64:
//
//     out[b, j] = table[(b / 64) * 65536 + wid[b] * 1024 + local[b, j]]
//
// What bounds it.  Per slot the card must read `local` (4 B) and write `out`
// (4 B); per row it reads `wid` (4 B); and it must read each distinct
// (region, window) pair's 4 KB once.  At the probe's 1,024 regions (67.1M
// slots) with its default_rng(2) windows that is 537 MB of slots, 170 MB of
// windows (41,556 distinct of 65,536) and 0.26 MB of `wid`: 707 MB, 0.211 ms at
// 3.35 TB/s.  There is no arithmetic: bound by bytes.
//
// How the design meets it (K1's structure, csrc/gather_window.cu, without the
// multiply).  One 256-thread block per 1024-slot row:
//   - each thread loads its four `local` indices as one int4 first, so the
//     load overlaps the block's read of wid[b];
//   - the block stages the row's 4 KB window into shared memory with one
//     16-byte load per thread (coalesced);
//   - each thread resolves its four indices in shared memory and stores one
//     float4 (coalesced).
// The TPU kernel kept one whole 256 KB region resident per grid step; that
// does not fit the 227 KB of shared memory a Hopper block can use, and a row
// only ever reads its own 4 KB window, so the block stages just that.
// Like K1, an out-of-range `wid` is clamped and `local` masked to the window,
// so a corrupt operand cannot read outside the table.
//
// Numerics: a pure copy, bit-equal to the plain PyTorch version.
//
// C interface (loaded with ctypes by protocol_tpu_torch/ops/_build.py):
//     int gather_region(wid, table, local, out, n_rows, stream)
// launches on `stream` and returns cudaGetLastError() (0 on success).

#include <cuda_runtime.h>

namespace {

constexpr int kWindow = 1024;              // table entries per window (= slots per row)
constexpr int kWindowsPerRegion = 64;      // rows per region (the TPU's grid step)
constexpr int kThreads = kWindow / 4;      // one float4 of slots per thread

__global__ void __launch_bounds__(kThreads)
gather_region_kernel(const int* __restrict__ wid, const float* __restrict__ table,
                     const int* __restrict__ local, float* __restrict__ out) {
  __shared__ float4 win4[kThreads];
  const long long row = blockIdx.x;
  const long long slot4 = row * kThreads + threadIdx.x;  // index in float4 units

  const int4 idx = reinterpret_cast<const int4*>(local)[slot4];

  const long long region = row / kWindowsPerRegion;
  const int w = min(max(__ldg(wid + row), 0), kWindowsPerRegion - 1);
  const long long base = (region * kWindowsPerRegion + w) * kWindow;
  win4[threadIdx.x] = reinterpret_cast<const float4*>(table + base)[threadIdx.x];
  __syncthreads();

  const float* win = reinterpret_cast<const float*>(win4);
  float4 r;
  r.x = win[idx.x & (kWindow - 1)];
  r.y = win[idx.y & (kWindow - 1)];
  r.z = win[idx.z & (kWindow - 1)];
  r.w = win[idx.w & (kWindow - 1)];
  reinterpret_cast<float4*>(out)[slot4] = r;
}

}  // namespace

extern "C" int gather_region(const void* wid, const void* table, const void* local, void* out,
                             long long n_rows, void* stream) {
  if (n_rows <= 0) return 0;
  gather_region_kernel<<<static_cast<unsigned int>(n_rows), kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(wid), static_cast<const float*>(table),
      static_cast<const int*>(local), static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}
