// The windowed step's row prefix and bridge in one kernel, on Hopper: from the gathered
// plan slots straight to the dst-order run partials.
//
// Replaces two jit'd XLA passes of the reference, neither of them a Pallas kernel: the
// double-single row prefix `_ds_cumsum_axis1` of protocol_tpu/ops/sparse.py:80 over the
// (n_rows, 1024) slots, and `bridge_partials` of protocol_tpu/ops/gather_window.py:1007,
// composed by `windowed_ct` at :1069-1074.  The port's plain version, `prefix_bridge_plain`
// in protocol_tpu_torch/ops/gather_window.py, is that composition.  For every plan row:
//
//     (hi, lo) = (x, +0.0); for s = 1, 2, ..., 512:
//         (hi[i], lo[i]) = ds_add(hi[i], lo[i], hi[i-s], lo[i-s])   (previous level's values,
//                                                                     (+0.0, +0.0) where i < s)
//
// then, for every bucket-order run s with end slot e = seg_end[s]:
//
//     (ph, pl) = (+0.0, +0.0) where s == 0 or seg_first[s], else the prefix at seg_end[s-1]
//     partial[s] = (hi[e] - ph) + (lo[e] - pl)
//
// and last out[j] = partial[seg_perm[j]].
//
// Op order is the contract: the partials are bit-identical to the JAX package on the CPU,
// so the kernel must equal the plain version bit for bit, signed zeros included.  The
// row scan and ds_add are ds_cumsum_rows.cu's (ds_scan.cuh); the run partials subtract
// with __fadd_rn / __fsub_rn, and the source is never built with --use_fast_math or
// -ftz=true (denormals survive as in PyTorch).
//
// What bounds it.  The function must read the slots of the rows that hold runs (4 B a
// slot), seg_end, seg_perm (4 B a run each), seg_first (1 B a run) and the row pointers,
// and write out (4 B a run): 425 MB at the headline (51,119 of 52,416 rows hold runs;
// 16.5M-run capacity), 0.127 ms at 3.35 TB/s.  Its 11 float adds a slot a level over 10
// levels are 5.8 G operations, 0.087 ms at 67 TFLOP/s; but adds are not fused
// multiply-adds, so the card issues them at half that rate (~0.17 ms at the 1.98 GHz
// boost clock), and that, not the bytes, is the floor of any kernel that keeps this op
// tree.
//
// How the design meets it.  The two kernels it replaces met at two float32 lanes of row
// prefixes, 430 MB written and read back at the run ends; here the prefix never leaves
// the chip.  Two launches on the stream:
//   - launch 1, one block of 256 threads per plan row, four consecutive slots a thread
//     (one 16-byte load).  A row with no runs (the spare rows) returns before any barrier.
//     The scan is K5's (`ds_scan_row`): ten Hillis-Steele levels through double-buffered
//     shared memory, one barrier a level.  Then the row's (hi, lo) goes into the buffer
//     the last level did not read (8 KB), one barrier, and thread j takes runs
//     row_run_ptr[r] + j, + 256, ...: seg_end and seg_first read coalesced, both
//     prefixes read from shared memory, `partial` written coalesced in bucket order into
//     an S-float scratch.  (A scan that takes in-warp partners by __shfl_up_sync and
//     publishes only cross-warp lanes through shared memory, and one with a warp a row
//     and no barrier, were both bit-equal and both slower: PERF.md has the times.)
//   - launch 2, the permutation out[j] = partial[seg_perm[j]], four outputs a thread: one
//     16-byte seg_perm load feeds four independent reads of the scratch (66 MB at the
//     headline, larger than the 50 MB L2, so they are random sector reads) and one 16-byte
//     store; a scalar tail where S is not a multiple of 4.  The streamed operands (slots,
//     seg_perm, out) are loaded and stored evict-first, so that more of the scratch that
//     launch 1 writes is still in L2 when launch 2 reads it.
//
// Precondition: every row's first run is run 0 or is flagged seg_first (a run breaks at
// each row start and pad runs are all flagged, protocol_tpu/ops/gather_window.py:264-278
// and :451), and row_run_ptr[r] is the first run that ends in row r (`row_run_ptr` in
// gather_window.py checks both).  The kernel clamps the row pointers into [0, S], masks
// run ends into their row and clamps seg_perm into [0, S), so operands that break the
// precondition (a row pointer table of another plan, say) give wrong partials, never an
// out-of-bounds access.
//
// C interface (loaded with ctypes by protocol_tpu_torch/ops/_build.py):
//     int prefix_bridge(slots, seg_end, seg_first, seg_perm, row_run_ptr, partial, out,
//                       n_rows, s, stream)
// with slots (n_rows, 1024) float32, seg_end and seg_perm (s) int32, row_run_ptr
// (n_rows + 1) int32, seg_first one byte a run (0 or 1), `partial` S floats of scratch;
// every pointer 16-byte aligned.  Launches on `stream` and returns cudaGetLastError()
// (0 on success), or cudaErrorInvalidValue for sizes out of range.

#include "ds_scan.cuh"

namespace {

constexpr int kRow = 1024;
constexpr int kThreads = kRow / 4;  // four slots a thread
// ds_scan_row's last level (s = 512, the tenth) reads buffer 1: buffer 0 is free after it.
constexpr int kFree = 0;

__global__ void __launch_bounds__(kThreads)
prefix_rows_kernel(const float* __restrict__ slots, const int* __restrict__ seg_end,
                   const unsigned char* __restrict__ seg_first,
                   const int* __restrict__ row_run_ptr, float* __restrict__ partial,
                   int n_runs) {
  __shared__ float4 sh[2][kThreads];
  __shared__ float4 sl[2][kThreads];
  const int r = blockIdx.x;
  const int first_run = min(max(row_run_ptr[r], 0), n_runs);
  const int end_run = min(max(row_run_ptr[r + 1], 0), n_runs);
  if (first_run >= end_run) return;  // the whole block: no run ends in this row

  const int t = threadIdx.x;
  const float4 x = __ldcs(reinterpret_cast<const float4*>(slots) +
                          static_cast<long long>(r) * kThreads + t);
  float h[4] = {x.x, x.y, x.z, x.w};
  float l[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  ds_scan_row<kRow>(h, l, sh, sl);

  float* const fh = reinterpret_cast<float*>(sh[kFree]);
  float* const fl = reinterpret_cast<float*>(sl[kFree]);
  sh[kFree][t] = make_float4(h[0], h[1], h[2], h[3]);
  sl[kFree][t] = make_float4(l[0], l[1], l[2], l[3]);
  __syncthreads();
  for (int s = first_run + t; s < end_run; s += kThreads) {
    const int e = seg_end[s] & (kRow - 1);
    float ph = 0.0f, pl = 0.0f;
    if (s != 0 && !seg_first[s]) {
      const int p = seg_end[s - 1] & (kRow - 1);
      ph = fh[p];
      pl = fl[p];
    }
    partial[s] = __fadd_rn(__fsub_rn(fh[e], ph), __fsub_rn(fl[e], pl));
  }
}

__global__ void __launch_bounds__(kThreads)
permute4_kernel(const float* __restrict__ partial, const int* __restrict__ seg_perm,
                float* __restrict__ out, long long n) {
  const long long q = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  const long long j = 4 * q;
  const auto last = static_cast<unsigned int>(n - 1);
  if (j + 4 <= n) {
    const int4 p = __ldcs(reinterpret_cast<const int4*>(seg_perm) + q);
    float4 o;
    o.x = __ldg(partial + min(static_cast<unsigned int>(p.x), last));
    o.y = __ldg(partial + min(static_cast<unsigned int>(p.y), last));
    o.z = __ldg(partial + min(static_cast<unsigned int>(p.z), last));
    o.w = __ldg(partial + min(static_cast<unsigned int>(p.w), last));
    __stcs(reinterpret_cast<float4*>(out) + q, o);
  } else {
    for (long long k = j; k < n; ++k) {
      out[k] = __ldg(partial + min(static_cast<unsigned int>(seg_perm[k]), last));
    }
  }
}

}  // namespace

extern "C" int prefix_bridge(const void* slots, const void* seg_end, const void* seg_first,
                             const void* seg_perm, const void* row_run_ptr, void* partial,
                             void* out, long long n_rows, long long s, void* stream) {
  if (s <= 0) return 0;
  if (s > 0x7fffffffLL || n_rows <= 0 || n_rows > 0x7fffffffLL ||
      n_rows * kRow > 0x80000000LL) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const auto st = static_cast<cudaStream_t>(stream);
  prefix_rows_kernel<<<static_cast<unsigned int>(n_rows), kThreads, 0, st>>>(
      static_cast<const float*>(slots), static_cast<const int*>(seg_end),
      static_cast<const unsigned char*>(seg_first), static_cast<const int*>(row_run_ptr),
      static_cast<float*>(partial), static_cast<int>(s));
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const auto grid = static_cast<unsigned int>(((s + 3) / 4 + kThreads - 1) / kThreads);
  permute4_kernel<<<grid, kThreads, 0, st>>>(static_cast<const float*>(partial),
                                             static_cast<const int*>(seg_perm),
                                             static_cast<float*>(out), s);
  return static_cast<int>(cudaGetLastError());
}
