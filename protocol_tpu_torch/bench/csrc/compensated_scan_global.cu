// A yardstick, off the main path: the earlier form of the block-total scan
// (protocol_tpu_torch/ops/csrc/compensated_scan.cu), one block climbing the level pyramid
// in a device-memory scratch.  chip_smoke.py times it beside the kernel that replaced it;
// the port never calls it.
//
// It computes the jit'd XLA pass `_compensated_cumsum` of
// protocol_tpu/ops/sparse.py:41 (part of ROADMAP B4), which is
// `lax.associative_scan(two_sum, (x, 0))`.  It is not a Pallas kernel in the
// reference; the port's plain version, `_compensated_cumsum` in
// protocol_tpu_torch/ops/sparse.py, reproduces the associative scan's odd/even
// recursion in some 500 small PyTorch calls.
//
// The recursion, scan(A) for a level A of m (hi, lo) pairs:
//   - m < 2: A itself, untouched;
//   - R[i] = two_sum(A[2i], A[2i+1]) for i < m/2, S' = scan(R);
//   - S[0] = A[0], S[2j] = two_sum(S'[j-1], A[2j]) for 2j < m,
//     S[2j+1] = S'[j];
//   - every S[i] then gets + 0.0 on both lanes (the associative scan's
//     pad-and-add interleave), which turns -0.0 into +0.0.
// two_sum is TwoSum on the hi lanes with lo = (a_lo + b_lo) + err and no
// renormalisation; it is not the row prefix's ds_add.
//
// Iterative form.  Level 0 is x with lo = +0.0; level k+1 has n >> (k+1)
// pairs and lives in `scratch` (pairs of floats) at offset
// sum_{j=1..k} (n >> j).  The up-sweep builds level k+1 from level k until a
// level has one pair (the recursion's base case, left untouched).  The
// down-sweep then turns level k into its scan in place, from the scan of level
// k+1 above it; level 0's scan goes to hi/lo.  In place is race-free: the
// thread for pair j reads only A[2j] of its own level (and level k+1, which
// nobody writes then) and writes only 2j and 2j+1.  A __syncthreads
// separates the levels; it orders the block's global-memory accesses as well.
//
// Op order is the contract, as for the row prefix: every add and subtract is
// __fadd_rn / __fsub_rn in two_sum's order, the interleave's + 0.0 is an
// explicit __fadd_rn(v, 0.0f) the compiler cannot drop, and the source is
// never built with --use_fast_math or -ftz=true.
//
// What bounds it.  In bytes almost nothing: 4 B read and 8 B written a pair,
// ~0.1 MB at the ~8,060 block totals of the headline's windowed step.  It runs
// as one block (1,024 threads), so in practice the ~2 log2(n) barrier-separated
// levels (~26-30) and their L2 latency bound it.  What it removes is the plain
// version's ~500 launches a step.
//
// C interface (loaded with ctypes by protocol_tpu_torch/ops/_build.py for
// protocol_tpu_torch/bench/yardsticks.py):
//     int compensated_scan_global(x, hi, lo, scratch, n, stream)
// with `scratch` holding at least n - 1 float pairs (8-byte aligned); launches
// on `stream` and returns cudaGetLastError() (0 on success).

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 1024;

__device__ __forceinline__ float2 two_sum(float2 a, float2 b) {
  const float s = __fadd_rn(a.x, b.x);
  const float bb = __fsub_rn(s, a.x);
  const float err = __fadd_rn(__fsub_rn(a.x, __fsub_rn(s, bb)), __fsub_rn(b.x, bb));
  return make_float2(s, __fadd_rn(__fadd_rn(a.y, b.y), err));
}

__device__ __forceinline__ float2 plus_zero(float2 a) {
  return make_float2(__fadd_rn(a.x, 0.0f), __fadd_rn(a.y, 0.0f));
}

__global__ void __launch_bounds__(kThreads)
compensated_scan_kernel(const float* __restrict__ x, float* __restrict__ hi,
                        float* __restrict__ lo, float2* scratch, long long n) {
  const int t = threadIdx.x;
  if (n < 2) {  // the recursion's base case: the input, untouched
    if (t == 0) {
      hi[0] = x[0];
      lo[0] = 0.0f;
    }
    return;
  }
  // Up-sweep.  Level 1 from x (lo = +0.0), then level k+1 from level k while
  // level k has at least two pairs.
  for (long long i = t; i < n / 2; i += kThreads)
    scratch[i] = two_sum(make_float2(x[2 * i], 0.0f), make_float2(x[2 * i + 1], 0.0f));
  __syncthreads();
  long long off = 0;  // offset of level k in scratch
  long long m = n / 2;  // pairs in level k
  int levels = 1;  // levels held in scratch
  while (m >= 2) {
    float2* a = scratch + off;
    float2* r = a + m;
    for (long long i = t; i < m / 2; i += kThreads) r[i] = two_sum(a[2 * i], a[2 * i + 1]);
    __syncthreads();
    off += m;
    m /= 2;
    ++levels;
  }
  // Down-sweep.  `off`/`m` walk back from the top level (one pair, its own
  // scan) to level 1; level k's scan replaces level k in place.
  for (int k = levels - 1; k >= 1; --k) {
    const long long up = off;  // the scan of level k+1
    m = n >> k;
    off -= m;
    float2* a = scratch + off;
    const float2* sup = scratch + up;
    for (long long j = t; 2 * j < m; j += kThreads) {
      const float2 even = j == 0 ? a[0] : two_sum(sup[j - 1], a[2 * j]);
      a[2 * j] = plus_zero(even);
      if (2 * j + 1 < m) a[2 * j + 1] = plus_zero(sup[j]);
    }
    __syncthreads();
  }
  // Level 0 from x and the scan of level 1 (at offset 0).
  for (long long j = t; 2 * j < n; j += kThreads) {
    const float2 a0 = make_float2(x[2 * j], 0.0f);
    const float2 even = plus_zero(j == 0 ? a0 : two_sum(scratch[j - 1], a0));
    hi[2 * j] = even.x;
    lo[2 * j] = even.y;
    if (2 * j + 1 < n) {
      const float2 odd = plus_zero(scratch[j]);
      hi[2 * j + 1] = odd.x;
      lo[2 * j + 1] = odd.y;
    }
  }
}

}  // namespace

extern "C" int compensated_scan_global(const void* x, void* hi, void* lo, void* scratch,
                                       long long n, void* stream) {
  if (n <= 0) return 0;
  compensated_scan_kernel<<<1, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<float*>(hi), static_cast<float*>(lo),
      static_cast<float2*>(scratch), n);
  return static_cast<int>(cudaGetLastError());
}
