// The edge gather-multiply of the CSR and COO steps on Hopper (K9):
//
//     contrib[e] = w[e] * t[src[e]]      for e < E
//
// Replaces the jit'd XLA product `w * t[src]` of `power_step_csr`
// (protocol_tpu/ops/sparse.py:147) and `power_step_coo` (:257), the first half of
// ROADMAP B5.  It is not a Pallas kernel in the reference; the port's plain version,
// `_gather_multiply` in protocol_tpu_torch/ops/sparse.py, is `w * t.index_select(0, src)`.
// A gathered index is clamped to [0, n), as XLA clamps a gather, so a bad index never
// reads outside the table; wherever the plain version is defined the two agree.
//
// Numerics: one IEEE float32 multiply an edge (`__fmul_rn`, nothing to contract), so the
// output equals the plain version bit for bit.  The source is never built with
// --use_fast_math or -ftz=true, so denormals survive as in PyTorch.
//
// What bounds it.  The card must read `src` and `w` (8 B an edge) and write `contrib`
// (4 B), and read the n-entry table once: 12 E + 4 n bytes, ~0.604 GB at the headline
// (1M peers / 50M edges), ~0.180 ms at 3.35 TB/s.  The gathers are random: the 4 MB
// table sits in the 50 MB L2, so they do not reach device memory after the first touch,
// but each is a 4-byte read out of a 32-byte L2 sector, and the card serves such reads at
// a rate well under its device-memory byte rate (the probe kernel K2 read a 4 MB row at
// random at ~108 G elements/s; PERF.md), which would put 50M gathers near 0.46 ms.
//
// How the design meets it.
//   - The streams `src`, `w` and `contrib` pass once, with evict-first hints
//     (`__ldcs` / `__stcs`), so their 600 MB do not push the table out of L2; the table
//     is read through the read-only path (`__ldg`), which keeps what it can in L1.
//   - A block takes a tile of kThreads * kPer consecutive edges, thread i the edges
//     tile + i + kThreads k for k < kPer: every load and store of a warp covers 128
//     contiguous bytes (coalesced), and a thread issues its kPer stream loads, then its
//     kPer gathers, before it uses any of them, so several gathers are in flight a thread.
//   - Accesses are 4-byte, so any element-aligned slice of a tensor is taken as it is:
//     no ragged head or tail needs code of its own, the bound check covers the end.
//
// C interface (loaded with ctypes by protocol_tpu_torch/ops/_build.py):
//     int gather_multiply(w, t, src, out, e, n, stream)
// with src int32, launches on `stream` and returns cudaGetLastError() (0 on success);
// e > 0 with n <= 0 returns cudaErrorInvalidValue.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kPer = 4;  // edges a thread
constexpr int kTile = kThreads * kPer;

__global__ void __launch_bounds__(kThreads)
gather_multiply_kernel(const float* __restrict__ w, const float* __restrict__ t,
                       const int* __restrict__ src, float* __restrict__ out, long long e,
                       long long n) {
  const long long base = static_cast<long long>(blockIdx.x) * kTile + threadIdx.x;
  int s[kPer];
  float wv[kPer];
  float tv[kPer];
#pragma unroll
  for (int k = 0; k < kPer; ++k) {
    const long long i = base + k * kThreads;
    s[k] = 0;
    wv[k] = 0.0f;
    if (i < e) {
      s[k] = __ldcs(src + i);
      wv[k] = __ldcs(w + i);
    }
  }
#pragma unroll
  for (int k = 0; k < kPer; ++k) {
    const long long j = min(max(static_cast<long long>(s[k]), 0LL), n - 1);
    tv[k] = base + k * kThreads < e ? __ldg(t + j) : 0.0f;
  }
#pragma unroll
  for (int k = 0; k < kPer; ++k) {
    const long long i = base + k * kThreads;
    if (i < e) __stcs(out + i, __fmul_rn(wv[k], tv[k]));
  }
}

}  // namespace

extern "C" int gather_multiply(const void* w, const void* t, const void* src, void* out,
                               long long e, long long n, void* stream) {
  if (e <= 0) return 0;
  if (n <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const long long grid = (e + kTile - 1) / kTile;
  if (grid > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  gather_multiply_kernel<<<static_cast<unsigned int>(grid), kThreads, 0,
                           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(w), static_cast<const float*>(t),
      static_cast<const int*>(src), static_cast<float*>(out), e, n);
  return static_cast<int>(cudaGetLastError());
}
