// take_along_axis over a 2-D float32 table, on Hopper: gathers served from a table staged
// on chip.
//
// Replaces the anonymous Pallas kernel of bench/probe_mosaic_gather.py
// (`bench_gather`, lines 69-92, pallas_call at line 75), which probed Mosaic's
// in-block dynamic gather.  For a (R, L) table `t` and int32 indices `idx` of
// the same shape it computes
//
//     axis 1:  out[r, c] = t[r, idx[r, c]]      (idx clamped into [0, L))
//     axis 0:  out[r, c] = t[idx[r, c], c]      (idx clamped into [0, R))
//
// An index outside its range is clamped into it, so a corrupt index cannot read outside
// `t`.  Numerics: a pure copy, bit-equal to the plain PyTorch version.
//
// What bounds it.  Per element the card must read `idx` (4 B) and write `out` (4 B), and
// read `t` once (4 B): 12.6 MB at the probe's 1,048,576-element shapes (3.8 us at
// 3.35 TB/s), 100.7 MB at (8, 1048576) (30 us).  Bytes, not arithmetic.  The earlier form
// (bench/csrc/take_along_axis_ldg.cu) read every `t[r, idx]` with its own load, so each
// output element cost one random 32-byte sector of L1 or L2 (~108 G sectors a second
// from L2 on an H100).
//
// The design.  The wrapper (protocol_tpu_torch/bench/probe_mosaic_gather.py,
// `take_along_axis_geometry`) chooses a regime from (axis, R, L) and hands the launch its
// geometry; the kernel checks it.  Each regime is taken where it was the fastest of the
// forms timed on an H100 (PERF.md §6 keeps the times of the forms that lost: rows split
// over a cluster's distributed shared memory or cut into cluster-sized segments, axis-0
// column strips and column groups):
//
//   1 smem      axis 1, rows of 4,097 to kStageMaxFloats floats: a block stages one whole
//               row into shared memory with 16-byte cp.async, loads its first indices
//               meanwhile, and serves part `q` of the row's `parts` (`parts` blocks stage
//               the same row where rows are fewer than two a SM).  Each staged byte
//               serves one element, where the earlier form fetched a 32-byte sector for
//               each element.
//   2 direct    no staging: `per` (4, 8 or 16) elements a thread, every table load
//               (__ldg) in flight before any is used, so a row that fits L1 is served from
//               there with many loads in flight.  Rows up to 16 KB, rows of more than
//               kStageMaxFloats floats, and axis 0.
//
// C interface (loaded with ctypes by protocol_tpu_torch/ops/_build.py):
//     int take_along_axis(t, idx, out, rows, cols, axis, regime, parts, per, stream)
// with cols % 4 == 0 and every pointer 16-byte aligned; launches on `stream` and returns
// cudaGetLastError() (0 on success), or cudaErrorInvalidValue for a geometry the regime
// cannot serve.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

// Floats a block stages at most: 200 KB of the 227 KB a block may hold.
constexpr long long kStageMaxFloats = 51200;
// Threads of a staging block, and of a direct block.
constexpr int kThreads = 512;
constexpr int kDirectThreads = 256;

enum Regime : int { kSmem = 1, kDirect = 2 };

__device__ __forceinline__ int clamp_index(int k, long long n) {
  return static_cast<int>(min(max(static_cast<long long>(k), 0LL), n - 1));
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Part q of n items split into `parts`: [lo, hi).
__device__ __forceinline__ void part_range(long long n, long long q, long long parts,
                                           long long& lo, long long& hi) {
  lo = q * n / parts;
  hi = (q + 1) * n / parts;
}

// Every thread copies its share of `n4` float4 units from `src` into `dst` with 16-byte
// cp.async; the caller waits with cp_async_wait_all() and a barrier.
__device__ __forceinline__ void stage_async(float4* dst, const float4* src, long long n4) {
  for (long long u = threadIdx.x; u < n4; u += blockDim.x) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_addr(dst + u)),
                 "l"(src + u)
                 : "memory");
  }
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// Regime 1, axis 1: block b stages row r = b / parts and gathers the float4 units of part
// b % parts of it, two units a thread in flight.
__global__ void __launch_bounds__(kThreads)
take_rows_smem(const float* __restrict__ t, const int4* __restrict__ idx,
               float4* __restrict__ out, long long cols, long long parts) {
  extern __shared__ float4 stage4[];
  const float* row = reinterpret_cast<const float*>(stage4);
  const long long base4 = blockIdx.x / parts * cols / 4;  // the row's first float4 unit
  long long lo, hi;
  part_range(cols / 4, blockIdx.x % parts, parts, lo, hi);
  if (lo >= hi) return;
  stage_async(stage4, reinterpret_cast<const float4*>(t) + base4, cols / 4);
  // The first two units' indices load while the row arrives.
  const long long first = lo + threadIdx.x;
  int4 ka = first < hi ? __ldg(idx + base4 + first) : make_int4(0, 0, 0, 0);
  int4 kb = first + kThreads < hi ? __ldg(idx + base4 + first + kThreads) : make_int4(0, 0, 0, 0);
  cp_async_wait_all();
  __syncthreads();
  for (long long i = first; i < hi; i += 2 * kThreads) {
    const long long j = i + kThreads;
    if (i != first) {
      ka = __ldg(idx + base4 + i);
      kb = j < hi ? __ldg(idx + base4 + j) : make_int4(0, 0, 0, 0);
    }
    out[base4 + i] = make_float4(row[clamp_index(ka.x, cols)], row[clamp_index(ka.y, cols)],
                                 row[clamp_index(ka.z, cols)], row[clamp_index(ka.w, cols)]);
    if (j < hi)
      out[base4 + j] = make_float4(row[clamp_index(kb.x, cols)], row[clamp_index(kb.y, cols)],
                                   row[clamp_index(kb.z, cols)], row[clamp_index(kb.w, cols)]);
  }
}

// Regime 2: kUnits float4 units a thread, a block-width apart, every table load (__ldg,
// which keeps a row that fits L1 there) in flight before any is used.
template <int kUnits>
__global__ void __launch_bounds__(kDirectThreads)
take_direct(const float* __restrict__ t, const int4* __restrict__ idx, float4* __restrict__ out,
            long long n4, long long rows, long long cols, int axis) {
  const long long first =
      static_cast<long long>(blockIdx.x) * kUnits * kDirectThreads + threadIdx.x;
  int4 k[kUnits];
#pragma unroll
  for (int u = 0; u < kUnits; ++u) {
    const long long i = first + u * kDirectThreads;
    k[u] = i < n4 ? __ldg(idx + i) : make_int4(0, 0, 0, 0);
  }
  float v[kUnits][4];
#pragma unroll
  for (int u = 0; u < kUnits; ++u) {
    const long long e = 4 * min(first + u * kDirectThreads, n4 - 1);
    const long long r = e / cols, c = e - r * cols;
    const int ks[4] = {k[u].x, k[u].y, k[u].z, k[u].w};
#pragma unroll
    for (int j = 0; j < 4; ++j)
      v[u][j] = __ldg(axis == 1 ? t + r * cols + clamp_index(ks[j], cols)
                                : t + static_cast<long long>(clamp_index(ks[j], rows)) * cols + c + j);
  }
#pragma unroll
  for (int u = 0; u < kUnits; ++u) {
    const long long i = first + u * kDirectThreads;
    if (i < n4) out[i] = make_float4(v[u][0], v[u][1], v[u][2], v[u][3]);
  }
}

template <int kUnits>
int launch_direct(const float* t, const int4* idx, float4* out, long long rows, long long cols,
                  int axis, cudaStream_t stream) {
  const long long n4 = rows * cols / 4;
  const long long blocks = (n4 + kUnits * kDirectThreads - 1) / (kUnits * kDirectThreads);
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  take_direct<kUnits><<<static_cast<unsigned>(blocks), kDirectThreads, 0, stream>>>(
      t, idx, out, n4, rows, cols, axis);
  return static_cast<int>(cudaGetLastError());
}

// A staging kernel's dynamic shared-memory limit (48 KB unless raised), raised to
// kStageMaxFloats once a process: the launches run on one card.
int raise_smem_limit(const void* kernel) {
  static_assert(kStageMaxFloats * 4 <= 227 * 1024, "a block holds at most 227 KB");
  return static_cast<int>(cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(kStageMaxFloats * 4)));
}

constexpr int kInvalid = static_cast<int>(cudaErrorInvalidValue);

}  // namespace

extern "C" int take_along_axis(const void* t_, const void* idx_, void* out_, long long rows,
                               long long cols, long long axis, long long regime, long long parts,
                               long long per, void* stream_) {
  if (rows <= 0 || cols <= 0) return 0;
  if (cols % 4 || (axis != 0 && axis != 1) || parts < 1) return kInvalid;
  const auto* t = static_cast<const float*>(t_);
  const auto* idx = static_cast<const int4*>(idx_);
  auto* out = static_cast<float4*>(out_);
  const auto stream = static_cast<cudaStream_t>(stream_);
  if (regime == kSmem) {
    if (axis != 1 || cols > kStageMaxFloats) return kInvalid;
    const long long blocks = rows * parts;
    if (blocks > 0x7fffffffLL) return kInvalid;
    static const int rc = raise_smem_limit(reinterpret_cast<const void*>(take_rows_smem));
    if (rc) return rc;
    take_rows_smem<<<static_cast<unsigned>(blocks), kThreads, cols * 4, stream>>>(
        t, idx, out, cols, parts);
    return static_cast<int>(cudaGetLastError());
  }
  if (regime != kDirect) return kInvalid;
  const int a = static_cast<int>(axis);
  if (per == 4) return launch_direct<1>(t, idx, out, rows, cols, a, stream);
  if (per == 8) return launch_direct<2>(t, idx, out, rows, cols, a, stream);
  if (per == 16) return launch_direct<4>(t, idx, out, rows, cols, a, stream);
  return kInvalid;
}
