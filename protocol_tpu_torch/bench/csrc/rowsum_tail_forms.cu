// A probe, off the main path: the pointer tail (protocol_tpu_torch/ops/csrc/rowsum_tail.cu)
// in two layouts at 1, 2, 4 or 8 pointers a thread, over a resident grid with its
// grid-stride loop or over every block its pointers need:
//   - layout 0, interleaved: the port's kernel, a warp's tile of 32 * PER pointers with
//     lane l at tile + 32 i + l, each slot's reads and writes coalesced;
//   - layout 1, consecutive: thread g at pointers PER g .. PER g + PER - 1 (one int2 or
//     int4 read, one float2 or float4 store), so a warp's slot-i reads fall PER pointers
//     apart.
// Every form computes the same bits.  protocol_tpu_torch/bench/probe_tail_forms.py times
// them side by side.
//
// C interface (loaded with ctypes by protocol_tpu_torch/ops/_build.py):
//     int rowsum_tail_forms(wh, wl, hi_in, lo_in, row_ptr, out, n_blocks, block, n, per,
//                           resident, layout, stream)
// launches on `stream` and returns cudaGetLastError() (0 on success); another `per` than
// 1, 2, 4 or 8, or another layout, returns cudaErrorInvalidValue.

#include "rowsum_tail.cu"

namespace {

// The consecutive layout: the same arithmetic as rowsum_tail_kernel; lane 31 reads the
// pointer after its last one and the others take it from the next lane.
template <int PER>
__global__ void __launch_bounds__(kThreads)
consecutive_kernel(const float* __restrict__ wh, const float* __restrict__ wl,
                   const float* __restrict__ hi_in, const float* __restrict__ lo_in,
                   const int* __restrict__ row_ptr, float* __restrict__ out, int n_blocks,
                   int block, long long n) {
  static_assert(PER == 1 || PER == 2 || PER % 4 == 0, "PER is 1, 2 or a multiple of 4");
  const int lane = threadIdx.x & 31;
  const long long groups = (n + PER) / PER;  // of the n + 1 pointers
  const long long stride = static_cast<long long>(gridDim.x) * kThreads;
  // `base` is the same for the whole warp, so its lanes run the same iterations.
  for (long long base = static_cast<long long>(blockIdx.x) * kThreads + (threadIdx.x & ~31);
       base < groups; base += stride) {
    const long long j0 = (base + lane) * PER;  // this thread's first pointer
    // Pointers j0 .. j0 + PER - 1 that exist (<= n), in one vector load where all do;
    // lane 31's next one, j0 + PER, where its last output needs it.
    int ptr[PER + 1];
    bool have[PER + 1];
    if (j0 + PER - 1 <= n) {
      if constexpr (PER == 1) {
        ptr[0] = row_ptr[j0];
      } else if constexpr (PER == 2) {
        const int2 v = *reinterpret_cast<const int2*>(row_ptr + j0);
        ptr[0] = v.x;
        ptr[1] = v.y;
      } else {
#pragma unroll
        for (int i = 0; i < PER; i += 4) {
          const int4 v = *reinterpret_cast<const int4*>(row_ptr + j0 + i);
          ptr[i] = v.x;
          ptr[i + 1] = v.y;
          ptr[i + 2] = v.z;
          ptr[i + 3] = v.w;
        }
      }
#pragma unroll
      for (int i = 0; i < PER; ++i) have[i] = true;
    } else {
#pragma unroll
      for (int i = 0; i < PER; ++i) {
        have[i] = j0 + i <= n;
        ptr[i] = have[i] ? row_ptr[j0 + i] : 0;
      }
    }
    have[PER] = lane == 31 && j0 + PER <= n;
    ptr[PER] = have[PER] ? row_ptr[j0 + PER] : 0;
    // Every read first, then the adds.
    float bh[PER + 1], bl[PER + 1], vh[PER + 1], vl[PER + 1];
    bool live[PER + 1];
#pragma unroll
    for (int i = 0; i <= PER; ++i) {
      const int p = ptr[i] - 1;
      live[i] = have[i] && p >= 0;
      bh[i] = bl[i] = vh[i] = vl[i] = 0.0f;
      if (live[i]) {
        const int blk = min(p / block, n_blocks - 1);
        const long long at = static_cast<long long>(blk) * block + p % block;
        if (blk > 0) {
          bh[i] = hi_in[blk - 1];
          bl[i] = lo_in[blk - 1];
        }
        vh[i] = wh[at];
        vl[i] = wl[at];
      }
    }
    float ph[PER + 1], pl[PER + 1];
#pragma unroll
    for (int i = 0; i <= PER; ++i) {
      ph[i] = bh[i];
      pl[i] = bl[i];
      ds_add(ph[i], pl[i], vh[i], vl[i]);
      if (!live[i]) ph[i] = pl[i] = 0.0f;
    }
    // P(j0 + PER) from the next lane's first prefix; lane 31 computed its own.
    const float nh = __shfl_down_sync(0xffffffffu, ph[0], 1);
    const float nl = __shfl_down_sync(0xffffffffu, pl[0], 1);
    if (lane != 31) {
      ph[PER] = nh;
      pl[PER] = nl;
    }
    float o[PER];
#pragma unroll
    for (int i = 0; i < PER; ++i)
      o[i] = __fadd_rn(__fsub_rn(ph[i + 1], ph[i]), __fsub_rn(pl[i + 1], pl[i]));
    if (j0 + PER <= n) {
      if constexpr (PER == 1) {
        out[j0] = o[0];
      } else if constexpr (PER == 2) {
        *reinterpret_cast<float2*>(out + j0) = make_float2(o[0], o[1]);
      } else {
#pragma unroll
        for (int i = 0; i < PER; i += 4) {
          *reinterpret_cast<float4*>(out + j0 + i) =
              make_float4(o[i], o[i + 1], o[i + 2], o[i + 3]);
        }
      }
    } else {
#pragma unroll
      for (int i = 0; i < PER; ++i)
        if (j0 + i < n) out[j0 + i] = o[i];
    }
  }
}

template <int PER>
int launch_consecutive(const float* wh, const float* wl, const float* hi_in,
                       const float* lo_in, const int* row_ptr, float* out, long long n_blocks,
                       long long block, long long n, bool resident, cudaStream_t stream) {
  if (n <= 0) return 0;
  if (n_blocks <= 0 || n_blocks > 0x7fffffffLL || block <= 0 || block > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long needed = ((n + PER) / PER + kThreads - 1) / kThreads;
  long long grid = needed;
  if (resident) {
    int dev = 0, sms = 0, per_sm = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess ||
        cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, consecutive_kernel<PER>,
                                                      kThreads, 0) != cudaSuccess)
      return static_cast<int>(cudaGetLastError());
    grid = needed < sms * per_sm ? needed : sms * per_sm;
  }
  consecutive_kernel<PER><<<static_cast<unsigned int>(grid), kThreads, 0, stream>>>(
      wh, wl, hi_in, lo_in, row_ptr, out, static_cast<int>(n_blocks), static_cast<int>(block),
      n);
  return static_cast<int>(cudaGetLastError());
}

template <int PER>
int launch_form(const float* h, const float* l, const float* bh, const float* bl,
                const int* p, float* o, long long n_blocks, long long block, long long n,
                bool resident, long long layout, cudaStream_t s) {
  if (layout == 0) return launch_tail<PER>(h, l, bh, bl, p, o, n_blocks, block, n, resident, s);
  if (layout == 1)
    return launch_consecutive<PER>(h, l, bh, bl, p, o, n_blocks, block, n, resident, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

extern "C" int rowsum_tail_forms(const void* wh, const void* wl, const void* hi_in,
                                 const void* lo_in, const void* row_ptr, void* out,
                                 long long n_blocks, long long block, long long n,
                                 long long per, long long resident, long long layout,
                                 void* stream) {
  const auto* h = static_cast<const float*>(wh);
  const auto* l = static_cast<const float*>(wl);
  const auto* bh = static_cast<const float*>(hi_in);
  const auto* bl = static_cast<const float*>(lo_in);
  const auto* p = static_cast<const int*>(row_ptr);
  auto* o = static_cast<float*>(out);
  const auto s = static_cast<cudaStream_t>(stream);
  const bool r = resident != 0;
  switch (per) {
    case 1: return launch_form<1>(h, l, bh, bl, p, o, n_blocks, block, n, r, layout, s);
    case 2: return launch_form<2>(h, l, bh, bl, p, o, n_blocks, block, n, r, layout, s);
    case 4: return launch_form<4>(h, l, bh, bl, p, o, n_blocks, block, n, r, layout, s);
    case 8: return launch_form<8>(h, l, bh, bl, p, o, n_blocks, block, n, r, layout, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
