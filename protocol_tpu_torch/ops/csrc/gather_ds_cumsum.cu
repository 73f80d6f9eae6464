// The CSR and COO steps' edge product and the block-local double-single prefix of
// `rowsum_sorted`, in one kernel on Hopper (K9):
//
//     x[e] = w[e] * t[clamp(src[e], 0, n - 1)]   for e < E;  x[e] = +0.0 for E <= e < R * B
//     (hi, lo)[r, :] = the inclusive double-single prefix of x[r * B : (r + 1) * B]
//
// with R = ceil(E / B) rows of B = 2048, `rowsum_sorted`'s block.  It replaces two jit'd
// XLA passes of the reference, one after the other: the product `w * t[src]` of
// `power_step_csr` (protocol_tpu/ops/sparse.py:147) and `power_step_coo` (:257), and the
// Hillis-Steele pass `_ds_cumsum_axis1` (:80) over `rowsum_sorted`'s zero-padded
// 2048-blocks (padding at :121, scan at :122).  Neither is a Pallas kernel in the
// reference.  The port's plain version, `_gather_ds_cumsum` in
// protocol_tpu_torch/ops/sparse.py, is `_ds_cumsum_blocks(_gather_multiply(w, t, src), B)`.
// The padding slots are +0.0, not the product of a gathered value.  An index is clamped to [0, n), so a bad index never
// reads outside the table; that equals the reference's `t[src]` for an index >= n, but
// where JAX wraps a negative index (-1 reads t[n - 1]), the clamp reads t[0].
//
// Numerics.  One IEEE float32 multiply an edge (`__fmul_rn`, nothing to contract), then
// ds_cumsum_rows.cu's row scan, `ds_scan_row` from ds_scan.cuh, unchanged: the lanes equal
// the earlier pair (bench/csrc/gather_multiply.cu, then ds_cumsum_rows.cu over its output)
// and the plain version bit for bit.  No source that includes ds_scan.cuh is built with
// --use_fast_math or -ftz=true, so denormals survive as in PyTorch.
//
// What bounds it.
//   - Bytes: `src` and `w` read (8 B an edge), both lanes written (8 B a slot), the
//     n-entry table read once: 8 E + 8 R B + 4 n, ~0.804 GB at the headline (1M peers,
//     49,999,949 edges, 24,415 rows of 2048), ~0.240 ms at 3.35 TB/s.
//   - Random reads: E gathers of 4 B, each out of a 32-byte L2 sector of a 4 MB table
//     that stays in the 50 MB L2.  The card served such reads at ~108 G a second (the
//     probe kernel K2 over a 4 MB row; PERF.md), ~0.46 ms for 50M.
//   - The scan: 11 float adds a slot a level (ds_add) over log2(B) levels, 6.05 G adds
//     at the headline, ~0.18 ms at the adds' issue rate (half the fused multiply-add
//     rate), and ~32 B of shared-memory traffic a slot a level.
// The earlier pair ran the gathers (L2) and then the scan (shared memory) one launch
// after the other, with the 200 MB of products written to device memory and read back
// between them.
//
// How the design meets it.  One block of B/4 threads a row, four consecutive edges a
// thread, as ds_cumsum_rows.cu lays a row out for `ds_scan_row`:
//   - one 16-byte load each of `w` (float4) and `src` (int4), evict-first (`__ldcs`) so
//     the 400 MB of streams do not push the table out of L2; the one thread that straddles
//     E reads its elements one by one, and no thread reads or gathers at or past E;
//   - its four gathers through the read-only path (`__ldg`), all issued before any is
//     used;
//   - the multiply, the scan, and one 16-byte store each of hi and lo.
// Nothing but the lanes reaches device memory.  The gain rests on occupancy: with up to
// 2048 threads an SM (`__launch_bounds__(B / 4, 4)`: at most 32 registers a thread, four
// blocks of 32 KB of shared memory), the warps of a block that wait on their gathers
// leave the SM to the warps of blocks that scan, so L2 and shared memory work at once.
//
// Alignment.  `w`, `src`, `hi` and `lo` must be 16-byte aligned (the wrapper checks, and a
// misaligned slice raises there; the steps and converges that call it take one aligned
// copy of a misaligned `w` or `src` first); the table `t` needs 4 bytes only.
//
// C interface (loaded with ctypes by protocol_tpu_torch/ops/_build.py):
//     int gather_ds_cumsum(w, t, src, hi, lo, e, n, stream)
// with src int32, hi and lo of ceil(e / 2048) rows of 2048; launches on `stream` and
// returns cudaGetLastError() (0 on success), or cudaErrorInvalidValue for e > 0 with
// n <= 0.

#include "ds_scan.cuh"

namespace {

constexpr int B = 2048;

__global__ void __launch_bounds__(B / 4, 4)
gather_ds_cumsum_kernel(const float* __restrict__ w, const float* __restrict__ t,
                        const int* __restrict__ src, float* __restrict__ hi_out,
                        float* __restrict__ lo_out, long long e, int last) {
  constexpr int kThreads = B / 4;
  __shared__ float4 sh[2][kThreads];
  __shared__ float4 sl[2][kThreads];
  const long long at = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;  // float4s
  const long long first = 4 * at;

  float wv[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  int s[4] = {0, 0, 0, 0};
  if (first + 4 <= e) {
    const float4 v = __ldcs(reinterpret_cast<const float4*>(w) + at);
    const int4 i = __ldcs(reinterpret_cast<const int4*>(src) + at);
    wv[0] = v.x; wv[1] = v.y; wv[2] = v.z; wv[3] = v.w;
    s[0] = i.x; s[1] = i.y; s[2] = i.z; s[3] = i.w;
  } else {
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      if (first + k < e) {
        wv[k] = __ldcs(w + first + k);
        s[k] = __ldcs(src + first + k);
      }
    }
  }
  // All four gathers in flight before any is used; none at or past E.
  float tv[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) tv[k] = first + k < e ? __ldg(t + min(max(s[k], 0), last)) : 0.0f;
  float h[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) h[k] = first + k < e ? __fmul_rn(wv[k], tv[k]) : 0.0f;
  float l[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  ds_scan_row<B>(h, l, sh, sl);
  reinterpret_cast<float4*>(hi_out)[at] = make_float4(h[0], h[1], h[2], h[3]);
  reinterpret_cast<float4*>(lo_out)[at] = make_float4(l[0], l[1], l[2], l[3]);
}

}  // namespace

extern "C" int gather_ds_cumsum(const void* w, const void* t, const void* src, void* hi,
                                void* lo, long long e, long long n, void* stream) {
  if (e <= 0) return 0;
  if (n <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const long long rows = (e + B - 1) / B;
  if (rows > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  // The largest index a gather may take: an int32 index never passes 2^31 - 1.
  const int last = static_cast<int>(n - 1 < 0x7fffffffLL ? n - 1 : 0x7fffffffLL);
  gather_ds_cumsum_kernel<<<static_cast<unsigned int>(rows), B / 4, 0,
                            static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(w), static_cast<const float*>(t), static_cast<const int*>(src),
      static_cast<float*>(hi), static_cast<float*>(lo), e, last);
  return static_cast<int>(cudaGetLastError());
}
