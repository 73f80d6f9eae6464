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
// Every lane read depends on a pointer read, so two memory round trips stand between a
// thread's first load and its result, and the design keeps several pointers in flight a
// thread:
//
//   - a warp takes a tile of 32 * kPer consecutive pointers (kPer = 4), lane l the
//     pointers tile + 32 i + l for slot i < kPer, so each slot's pointer reads, lane reads
//     and output stores are coalesced across the warp as in a one-pointer-a-thread kernel
//     (a thread's pointers side by side, read as one int4, put a warp's reads of one slot
//     4 pointers apart and measured slower: bench/probe_tail_forms.py);
//   - a thread issues all of its pointer reads, then all of its lane and block-prefix
//     reads, before it uses any of them;
//   - P(j+1) comes from the next lane's same slot by one shuffle, and for lane 31 from
//     lane 0's next slot; only lane 31 reads one pointer more, the first of the next tile,
//     for its last output;
//   - the grid is what the card holds resident, and a warp-uniform grid-stride loop walks
//     the rest, so every lane of a warp takes part in each shuffle.
//
// What the measurements say: this layout runs within about 1 % of the one-pointer form at
// 1, 2, 4 and 8 pointers a thread (bench/probe_tail_forms.py), so the lane sectors, not
// the latency chain, hold the kernel; see PERF.md.
//
// C interface (loaded with ctypes by protocol_tpu_torch/ops/_build.py):
//     int rowsum_tail(wh, wl, hi_in, lo_in, row_ptr, out, n_blocks, block, n, stream)
// with row_ptr int32 (n + 1 entries) and n_blocks >= 1;
// launches on `stream` and returns cudaGetLastError() (0 on success).

#include "ds_scan.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kPer = 4;  // pointers a thread

// The kernel for PER pointers a thread; the port launches PER = kPer over a resident
// grid, bench/csrc/rowsum_tail_forms.cu the other counts.  A warp takes a tile of 32 * PER
// consecutive pointers, lane l the pointers tile + 32 i + l (slot i < PER), so each slot's
// loads and stores stay coalesced across the warp.
template <int PER>
__global__ void __launch_bounds__(kThreads)
rowsum_tail_kernel(const float* __restrict__ wh, const float* __restrict__ wl,
                   const float* __restrict__ hi_in, const float* __restrict__ lo_in,
                   const int* __restrict__ row_ptr, float* __restrict__ out, int n_blocks,
                   int block, long long n) {
  constexpr int kTile = 32 * PER;
  const int lane = threadIdx.x & 31;
  const long long tiles = (n + kTile) / kTile;  // of the n + 1 pointers
  const long long warps = static_cast<long long>(gridDim.x) * (kThreads / 32);
  // The tile index is the same for the whole warp, so its lanes run the same iterations.
  for (long long w = static_cast<long long>(blockIdx.x) * (kThreads / 32) + threadIdx.x / 32;
       w < tiles; w += warps) {
    const long long j0 = w * kTile + lane;  // pointer of slot 0
    // Slot i's pointer where it exists (<= n); slot PER is lane 31's pointer after the
    // tile, where its last output needs it.
    int ptr[PER + 1];
    bool have[PER + 1];
#pragma unroll
    for (int i = 0; i < PER; ++i) {
      have[i] = j0 + 32 * i <= n;
      ptr[i] = have[i] ? row_ptr[j0 + 32 * i] : 0;
    }
    const long long next = j0 + kTile - 31;  // for lane 31, the first pointer of the next tile
    have[PER] = lane == 31 && next <= n;
    ptr[PER] = have[PER] ? row_ptr[next] : 0;
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
    // Slot i's output j = j0 + 32 i needs P(j + 1): the next lane's slot i, or for lane 31
    // lane 0's slot i + 1 (its own slot PER after the last).
#pragma unroll
    for (int i = 0; i < PER; ++i) {
      float qh = __shfl_down_sync(0xffffffffu, ph[i], 1);
      float ql = __shfl_down_sync(0xffffffffu, pl[i], 1);
      const float wrap_h = __shfl_sync(0xffffffffu, ph[i + 1], 0);
      const float wrap_l = __shfl_sync(0xffffffffu, pl[i + 1], 0);
      if (lane == 31) {
        qh = i + 1 < PER ? wrap_h : ph[PER];
        ql = i + 1 < PER ? wrap_l : pl[PER];
      }
      const long long j = j0 + 32 * i;
      if (j < n) out[j] = __fadd_rn(__fsub_rn(qh, ph[i]), __fsub_rn(ql, pl[i]));
    }
  }
}

// Blocks of the PER-pointer kernel the card holds resident at once, per device.
template <int PER>
int resident_blocks() {
  static int cached[64] = {};
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= 64) return 0;
  if (cached[dev] == 0) {
    int sms = 0, per_sm = 0;
    if (cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess ||
        cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, rowsum_tail_kernel<PER>,
                                                      kThreads, 0) != cudaSuccess)
      return 0;
    cached[dev] = sms * per_sm;
  }
  return cached[dev];
}

// Launch the PER-pointer kernel over min(needed, resident) blocks, or over every block
// its pointers need where `resident` is false.
template <int PER>
int launch_tail(const float* wh, const float* wl, const float* hi_in, const float* lo_in,
                const int* row_ptr, float* out, long long n_blocks, long long block,
                long long n, bool resident, cudaStream_t stream) {
  if (n <= 0) return 0;
  if (n_blocks <= 0 || n_blocks > 0x7fffffffLL || block <= 0 || block > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  constexpr int kTilesPerBlock = kThreads / 32;
  const long long tiles = (n + 32 * PER) / (32 * PER);
  const long long needed = (tiles + kTilesPerBlock - 1) / kTilesPerBlock;
  long long grid = needed;
  if (resident) {
    const int blocks = resident_blocks<PER>();
    if (blocks <= 0) {
      const cudaError_t err = cudaGetLastError();
      return static_cast<int>(err != cudaSuccess ? err : cudaErrorInvalidDevice);
    }
    grid = needed < blocks ? needed : blocks;
  }
  rowsum_tail_kernel<PER><<<static_cast<unsigned int>(grid), kThreads, 0, stream>>>(
      wh, wl, hi_in, lo_in, row_ptr, out, static_cast<int>(n_blocks), static_cast<int>(block),
      n);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int rowsum_tail(const void* wh, const void* wl, const void* hi_in,
                           const void* lo_in, const void* row_ptr, void* out, long long n_blocks,
                           long long block, long long n, void* stream) {
  return launch_tail<kPer>(
      static_cast<const float*>(wh), static_cast<const float*>(wl),
      static_cast<const float*>(hi_in), static_cast<const float*>(lo_in),
      static_cast<const int*>(row_ptr), static_cast<float*>(out), n_blocks, block, n, true,
      static_cast<cudaStream_t>(stream));
}
