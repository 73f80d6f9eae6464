// Inclusive double-single prefix sum along the rows of a (rows, B) matrix, on Hopper.
//
// Replaces the jit'd XLA pass `_ds_cumsum_axis1` (with `_ds_add`) of
// protocol_tpu/ops/sparse.py:80 (ROADMAP B2).  It is not a Pallas kernel in the
// reference; the port's plain version, `_ds_cumsum_axis1` in
// protocol_tpu_torch/ops/sparse.py, repeats its arithmetic pass by pass.  For
// every row it computes, from (hi, lo) = (x, +0.0), the Hillis-Steele scan
//
//     for s = 1, 2, 4, ... < B:
//         (hi[i], lo[i]) = ds_add(hi[i], lo[i], hi[i-s], lo[i-s])
//
// where every element reads the PREVIOUS level's values and (+0.0, +0.0)
// stands in for (hi[i-s], lo[i-s]) where i < s.  Those elements still go
// through ds_add: it renormalises (hi = s + e) and turns -0.0 into +0.0, as
// the reference's zero-filled shift does.
//
// Op order is the contract.  The prefix is bit-identical to the JAX package
// on the CPU, so the kernel must equal the plain version bit for bit: the
// scan and ds_add live in ds_scan.cuh, shared with prefix_bridge.cu (K7),
// which says what that asks of the build.
//
// What bounds it.  Per element the card must read x (4 B) and write hi and lo
// (8 B): 12 B a slot.  At the headline plan rows (52,416 x 1024, 53.7M
// slots) that is 0.644 GB, ~0.19 ms at 3.35 TB/s.  The arithmetic, 11 float
// adds a level over log2(B) levels, is below that at the card's float32 rate,
// so the bound is bytes.
//
// How the design meets it, right before fast.  One block per row, B/4
// threads, each holding 4 consecutive elements in registers:
//   - one coalesced 16-byte load of x per thread;
//   - log2(B) levels through double-buffered shared memory, one barrier a
//     level (`ds_scan_row`);
//   - one coalesced 16-byte store each of hi and lo.
// Shared memory: 4 float4s a thread, 16 KB at B = 1024 and 32 KB at B = 2048.
// Shared-memory traffic (~16 B an element a level), not device memory, likely
// bounds this simple form.  Note that the i-s neighbour crosses warps at every
// level from s = 4 on, so a warp-local scan does not reproduce Hillis-Steele.
//
// A ragged last row.  `x` holds n <= rows * cols elements; the kernel reads
// every element at or past n as +0.0, exactly the zero-padding that
// `rowsum_sorted` gives its 2048-blocks, so that pass needs no padded copy of
// its 50M contributions.  A thread whose four elements all lie below n still
// makes one 16-byte load; the one thread that straddles n reads its elements
// one by one.
//
// C interface (loaded with ctypes by protocol_tpu_torch/ops/_build.py):
//     int ds_cumsum_rows(x, hi, lo, rows, cols, n, stream)
// takes cols in {1024, 2048} and rows * cols - cols < n <= rows * cols,
// launches on `stream` and returns cudaGetLastError() (0 on success), or
// cudaErrorInvalidValue for another width or n.

#include "ds_scan.cuh"

namespace {

template <int B>
__global__ void __launch_bounds__(B / 4)
ds_cumsum_rows_kernel(const float* __restrict__ x, float* __restrict__ hi_out,
                      float* __restrict__ lo_out, long long n) {
  constexpr int kThreads = B / 4;
  __shared__ float4 sh[2][kThreads];
  __shared__ float4 sl[2][kThreads];
  const int t = threadIdx.x;
  const long long at = static_cast<long long>(blockIdx.x) * kThreads + t;  // float4 units

  float h[4];
  if (4 * at + 4 <= n) {
    const float4 v = reinterpret_cast<const float4*>(x)[at];
    h[0] = v.x; h[1] = v.y; h[2] = v.z; h[3] = v.w;
  } else {
#pragma unroll
    for (int k = 0; k < 4; ++k) h[k] = 4 * at + k < n ? x[4 * at + k] : 0.0f;
  }
  float l[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  ds_scan_row<B>(h, l, sh, sl);
  reinterpret_cast<float4*>(hi_out)[at] = make_float4(h[0], h[1], h[2], h[3]);
  reinterpret_cast<float4*>(lo_out)[at] = make_float4(l[0], l[1], l[2], l[3]);
}

}  // namespace

extern "C" int ds_cumsum_rows(const void* x, void* hi, void* lo, long long rows, long long cols,
                              long long n, void* stream) {
  if (rows <= 0) return 0;
  if (n > rows * cols || n <= (rows - 1) * cols) return static_cast<int>(cudaErrorInvalidValue);
  const auto s = static_cast<cudaStream_t>(stream);
  const auto grid = static_cast<unsigned int>(rows);
  const auto* in = static_cast<const float*>(x);
  auto* h = static_cast<float*>(hi);
  auto* l = static_cast<float*>(lo);
  if (cols == 1024) {
    ds_cumsum_rows_kernel<1024><<<grid, 1024 / 4, 0, s>>>(in, h, l, n);
  } else if (cols == 2048) {
    ds_cumsum_rows_kernel<2048><<<grid, 2048 / 4, 0, s>>>(in, h, l, n);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
