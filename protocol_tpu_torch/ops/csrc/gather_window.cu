// Windowed gather-multiply for the fused fixed-slot EigenTrust step, on Hopper.
//
// Replaces the Pallas kernel `_kernel` launched by `gather_windowed` in
// protocol_tpu/ops/gather_window.py (kernel body lines 318-336, pallas_call at
// line 370).  It computes, for every slot of the plan's (n_rows * 8, 128) slot
// matrix viewed as n_rows rows of 1024 slots,
//
//     out[r, j] = weight[r, j] * table[wid[r] * 1024 + local[r, j]]
//
// where each 1024-slot row reads only inside one 1024-entry window of the score
// table (the host-built WindowPlan guarantees local in [0, 1024)).
//
// What bounds it.  Per slot the card must read `local` (4 B) and `weight`
// (4 B) and write `out` (4 B): 12 B/slot, plus 4 B of `wid` per 1024 slots.
// The score table is at most ~4 MB and sits in the 50 MB L2, so its reads do
// not reach device memory after the first touch.  At the headline shape
// (1M peers / 50M edges, ~54k rows) that is ~0.65 GB a call, ~0.19 ms at
// 3.35 TB/s.  The one multiply per slot is negligible: the kernel is bound by
// bytes.
//
// How the design meets it.  One block per row, 256 threads, 4 slots each:
//   - the block reads wid[row] once and stages the row's 4 KB window into
//     shared memory with one 16-byte load per thread (coalesced);
//   - each thread reads its 4 `local` and 4 `weight` values as one int4 and
//     one float4 (coalesced 16-byte loads, issued before the barrier so they
//     overlap the window load), resolves the 4 indices in shared memory,
//     multiplies once each and stores one float4 (coalesced).
// Every device-memory byte is thus touched once, in 16-byte accesses; the
// random part of the gather lands in shared memory.  The TPU kernel's 8-way
// broadcast / lane-gather / select chain existed only because Mosaic cannot
// gather across vector registers, and has no counterpart here.
//
// Numerics: a single IEEE multiply per slot (`__fmul_rn`, nothing to
// contract), so the output equals the plain PyTorch version bit for bit.
//
// C interface (loaded with ctypes by protocol_tpu_torch/ops/_build.py):
//     int gather_window(wid, table, local, weight, out, n_rows, table_entries,
//                       stream)
// launches on `stream` and returns cudaGetLastError() (0 on success).

#include <cuda_runtime.h>

namespace {

constexpr int kWindow = 1024;          // table entries per window (= slots per row)
constexpr int kThreads = kWindow / 4;  // one float4 of slots per thread

__global__ void __launch_bounds__(kThreads)
gather_window_kernel(const int* __restrict__ wid, const float* __restrict__ table,
                     const int* __restrict__ local, const float* __restrict__ weight,
                     float* __restrict__ out, int n_windows) {
  __shared__ float4 win4[kThreads];
  const long long row = blockIdx.x;
  const long long slot4 = row * kThreads + threadIdx.x;  // index in float4 units

  // Slot operands first: independent of wid, so their loads overlap it.
  const int4 idx = reinterpret_cast<const int4*>(local)[slot4];
  const float4 wt = reinterpret_cast<const float4*>(weight)[slot4];

  // Clamp like the reference's dynamic slice: a plan never exceeds it, and the
  // clamp keeps a corrupt plan from reading outside the table.
  const int w = min(max(__ldg(wid + row), 0), n_windows - 1);
  win4[threadIdx.x] =
      reinterpret_cast<const float4*>(table + static_cast<long long>(w) * kWindow)[threadIdx.x];
  __syncthreads();

  const float* win = reinterpret_cast<const float*>(win4);
  float4 r;
  r.x = __fmul_rn(win[idx.x & (kWindow - 1)], wt.x);
  r.y = __fmul_rn(win[idx.y & (kWindow - 1)], wt.y);
  r.z = __fmul_rn(win[idx.z & (kWindow - 1)], wt.z);
  r.w = __fmul_rn(win[idx.w & (kWindow - 1)], wt.w);
  reinterpret_cast<float4*>(out)[slot4] = r;
}

}  // namespace

extern "C" int gather_window(const void* wid, const void* table, const void* local,
                             const void* weight, void* out, long long n_rows,
                             long long table_entries, void* stream) {
  if (n_rows <= 0) return 0;
  gather_window_kernel<<<static_cast<unsigned int>(n_rows), kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(wid), static_cast<const float*>(table),
      static_cast<const int*>(local), static_cast<const float*>(weight),
      static_cast<float*>(out), static_cast<int>(table_entries / kWindow));
  return static_cast<int>(cudaGetLastError());
}
