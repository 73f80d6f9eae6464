// The tail of `rowsum_sorted` on Hopper: pointer lookups into the blocked double-single
// prefix and hi/lo-separate row differencing.
//
// Replaces the jit'd XLA tail of `rowsum_sorted` at protocol_tpu/ops/sparse.py:121-132
// (part of ROADMAP B4).  It is not a Pallas kernel in the reference; the port's plain
// version, `_rowsum_tail` in protocol_tpu_torch/ops/sparse.py, repeats its arithmetic.
// Given the block-local prefix lanes (wh, wl) of n_blocks blocks of B and the inclusive
// scan (hi_in, lo_in) of the block totals, for every pointer k in 0..n:
//
//     i = row_ptr[k] - 1
//     i < 0:  P(k) = (+0.0, +0.0)
//     else:   blk = min(i / B, n_blocks - 1), off = i % B,
//             (bh, bl) = blk == 0 ? (+0.0, +0.0) : (hi_in[blk-1], lo_in[blk-1]),
//             P(k) = ds_add(bh, bl, wh[blk*B + off], wl[blk*B + off])
//
// and out[j] = (P(j+1).hi - P(j).hi) + (P(j+1).lo - P(j).lo) for j < n.
//
// Op order is the contract, as for the prefix kernels: ds_add (ds_scan.cuh) adds and
// subtracts with __fadd_rn / __fsub_rn in the reference's order, and the source is never
// built with --use_fast_math or -ftz=true.
//
// What bounds it.  The function reads the n+1 pointers (4 B each) and, for each, one
// element of both lanes (8 B), and writes n outputs (4 B): ~16 MB at n = 1M, ~0.005 ms at
// 3.35 TB/s.  The pointers are sorted, so each pointer's two lane reads are at most one
// 32-byte sector each: at most ~72 MB counted in sectors, ~0.02 ms (the headline's
// pointers share sectors: 43 MB, ~0.013 ms).  The block prefixes (65-195 KB) stay in L2.
// At these sizes one launch's own floor, ~5 us, is of the same order.
//
// How the design meets it.  One thread a pointer, row_ptr read coalesced, the lanes read
// at sorted positions.  Thread j computes P(j) and takes P(j+1) from the next lane by a
// warp shuffle; lane 31 computes P(j+1) itself.  Both computations of a pointer give the
// same bits.  It replaces the plain tail's ~30 launches with one.
//
// C interface (loaded with ctypes by protocol_tpu_torch/ops/_build.py):
//     int rowsum_tail(wh, wl, hi_in, lo_in, row_ptr, out, n_blocks, block, n, stream)
// with row_ptr int32 (n + 1 entries) and n_blocks >= 1; launches on `stream` and returns
// cudaGetLastError() (0 on success).

#include "ds_scan.cuh"

namespace {

constexpr int kThreads = 256;

// The inclusive double-single prefix before pointer value `ptr`.
__device__ __forceinline__ float2 prefix_at(const float* __restrict__ wh,
                                            const float* __restrict__ wl,
                                            const float* __restrict__ hi_in,
                                            const float* __restrict__ lo_in, int ptr,
                                            int n_blocks, int block) {
  const int i = ptr - 1;
  if (i < 0) return make_float2(0.0f, 0.0f);
  const int blk = min(i / block, n_blocks - 1);
  const long long at = static_cast<long long>(blk) * block + i % block;
  float h = 0.0f, l = 0.0f;
  if (blk > 0) {
    h = hi_in[blk - 1];
    l = lo_in[blk - 1];
  }
  ds_add(h, l, wh[at], wl[at]);
  return make_float2(h, l);
}

__global__ void __launch_bounds__(kThreads)
rowsum_tail_kernel(const float* __restrict__ wh, const float* __restrict__ wl,
                   const float* __restrict__ hi_in, const float* __restrict__ lo_in,
                   const int* __restrict__ row_ptr, float* __restrict__ out, int n_blocks,
                   int block, long long n) {
  const long long j = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  const int lane = threadIdx.x & 31;
  // Pointers run 0..n; a thread past them carries zeros through the shuffle.
  float2 p = make_float2(0.0f, 0.0f);
  if (j <= n) p = prefix_at(wh, wl, hi_in, lo_in, row_ptr[j], n_blocks, block);
  float2 q;
  q.x = __shfl_down_sync(0xffffffffu, p.x, 1);
  q.y = __shfl_down_sync(0xffffffffu, p.y, 1);
  if (j >= n) return;
  if (lane == 31) q = prefix_at(wh, wl, hi_in, lo_in, row_ptr[j + 1], n_blocks, block);
  out[j] = __fadd_rn(__fsub_rn(q.x, p.x), __fsub_rn(q.y, p.y));
}

}  // namespace

extern "C" int rowsum_tail(const void* wh, const void* wl, const void* hi_in,
                           const void* lo_in, const void* row_ptr, void* out, long long n_blocks,
                           long long block, long long n, void* stream) {
  if (n <= 0) return 0;
  if (n_blocks <= 0 || n_blocks > 0x7fffffffLL || block <= 0 || block > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  const auto grid = static_cast<unsigned int>((n + kThreads - 1) / kThreads);
  rowsum_tail_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(wh), static_cast<const float*>(wl),
      static_cast<const float*>(hi_in), static_cast<const float*>(lo_in),
      static_cast<const int*>(row_ptr), static_cast<float*>(out),
      static_cast<int>(n_blocks), static_cast<int>(block), n);
  return static_cast<int>(cudaGetLastError());
}
