// The double-single add and the row scan that the step's kernels share: ds_cumsum_rows.cu
// (K5) and prefix_bridge.cu (K7) scan rows with `ds_scan_row`, rowsum_tail.cu (K8) adds
// with `ds_add`.  Each .cu file includes this header and builds on its own.
//
// Op order is the contract: the prefixes are bit-identical to the JAX package on the CPU.
// Every add and subtract is __fadd_rn / __fsub_rn, in ds_add's order (e + al + bl is
// (e + al) + bl), so nothing is reassociated or contracted; and no source that includes
// this is built with --use_fast_math or -ftz=true: denormals survive on the CPU and must
// survive here.

#pragma once

#include <cuda_runtime.h>

namespace {

__device__ __forceinline__ void ds_add(float& ah, float& al, float bh, float bl) {
  const float s = __fadd_rn(ah, bh);
  const float v = __fsub_rn(s, ah);
  float e = __fadd_rn(__fsub_rn(ah, __fsub_rn(s, v)), __fsub_rn(bh, v));
  e = __fadd_rn(__fadd_rn(e, al), bl);
  const float hi = __fadd_rn(s, e);
  al = __fsub_rn(e, __fsub_rn(hi, s));
  ah = hi;
}

// The inclusive Hillis-Steele scan of one row of B elements, from (hi, lo) = (x, +0.0):
//
//     for s = 1, 2, 4, ... < B:
//         (hi[i], lo[i]) = ds_add(hi[i], lo[i], hi[i-s], lo[i-s])
//
// where every element reads the PREVIOUS level's values and (+0.0, +0.0) stands in for
// (hi[i-s], lo[i-s]) where i < s.  Those elements still go through ds_add: it
// renormalises (hi = s + e) and turns -0.0 into +0.0, as the reference's zero-filled
// shift does.
//
// Called by every thread of a block of B/4 threads; thread t holds elements 4t .. 4t+3 in
// (h, l).  log2(B) levels through shared memory, double-buffered so one barrier a level
// suffices: a thread writes its (hi, lo) float4s into buffer L % 2, waits, reads the i-s
// values from the same buffer and updates its registers.  A buffer written at level L+1
// was last read at level L-1, before every thread passed level L's barrier.  For s >= 4
// the i-s values of a thread's 4 elements are one aligned float4 (thread t - s/4); for
// s < 4 they are the thread's own previous-level registers and the float4 of thread t-1.
// The last level reads buffer (log2(B) - 1) % 2; the other buffer is free once it returns.
template <int B>
__device__ __forceinline__ void ds_scan_row(float (&h)[4], float (&l)[4],
                                            float4 (&sh)[2][B / 4], float4 (&sl)[2][B / 4]) {
  const int t = threadIdx.x;
  const float4 zero = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  int buf = 0;
#pragma unroll
  for (int s = 1; s < B; s <<= 1) {
    sh[buf][t] = make_float4(h[0], h[1], h[2], h[3]);
    sl[buf][t] = make_float4(l[0], l[1], l[2], l[3]);
    __syncthreads();
    // bh[k], bl[k]: the previous level's value at 4t + k - s, or +0.0.
    float bh[4], bl[4];
    if (s >= 4) {
      const int src = t - s / 4;
      const float4 ph = src >= 0 ? sh[buf][src] : zero;
      const float4 pl = src >= 0 ? sl[buf][src] : zero;
      bh[0] = ph.x; bh[1] = ph.y; bh[2] = ph.z; bh[3] = ph.w;
      bl[0] = pl.x; bl[1] = pl.y; bl[2] = pl.z; bl[3] = pl.w;
    } else {
      // Thread t-1's four elements, then this thread's own (previous level).
      const float4 ph = t > 0 ? sh[buf][t - 1] : zero;
      const float4 pl = t > 0 ? sl[buf][t - 1] : zero;
      const float wh[8] = {ph.x, ph.y, ph.z, ph.w, h[0], h[1], h[2], h[3]};
      const float wl[8] = {pl.x, pl.y, pl.z, pl.w, l[0], l[1], l[2], l[3]};
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        bh[k] = wh[4 + k - s];
        bl[k] = wl[4 + k - s];
      }
    }
#pragma unroll
    for (int k = 0; k < 4; ++k) ds_add(h[k], l[k], bh[k], bl[k]);
    buf ^= 1;
  }
}

}  // namespace
