// K12: the Pippenger MSM's per-window digit sort, on Hopper: a stable counting sort over a
// cluster of blocks a window.
//
// Replaces `protocol_tpu/zk/graft/pippenger.py:142` `window` (`zk-graft-msm-window`): for
// each of the 32 windows, the argsort of the windows' 8-bit digits and the digits in that
// order.  The reference takes the digits as the scalars' bytes transposed on the host
// (`pippenger.py:376`), argsorts them (`jnp.argsort`, stable) and gathers the points into a
// (32, m, 3, 16) batch; here the digits are read on the card straight from the (m, 4) uint64
// scalars (byte w of scalar i is window w's digit), and only the order `perm` and the sorted
// digits `ds` are written, (32, m) int32 each: K13 reads points[perm] itself, so the
// gathered batch (50 MB at m = 16,384) never reaches device memory.  The sort is stable:
// within one digit the lanes keep their order, so `perm` is the reference's order and equals
// the plain version's, `protocol_tpu_torch/zk/graft/pippenger.py::_window_plain` (a stable
// `torch.sort`), bit for bit.  (K13 still equals the plain buckets as points and not limb for
// limb: it adds a bucket's points in another grouping than the reference's 64-lane fold.)
//
// The design.  A window is a cluster of kCluster blocks (grid kCluster x 32); block r of a
// window's cluster owns the contiguous lanes [r * share, (r + 1) * share), share = ceil(m /
// kCluster), and sorts them in rounds of kRound lanes (one round up to m = kCluster * kRound).
//   1. Rank (`rank_round`): the block reads each digit of the round once into shared memory
//      (a warp's load is 32 neighbouring lanes' sectors); warp j ranks a contiguous chunk of
//      the round in passes of 32 lanes.  A lane's peers (the pass's lanes with its digit) come
//      from eight ballots, one a bit of the digit, ANDed with the valid lanes, so lanes past
//      the share are in no count; its rank is the count of its digit in the warp's earlier
//      passes (a running count per warp and digit in shared memory, read and bumped by the
//      group's first lane) plus its peers below it.  No atomics.
//   2. Offsets: per digit a walk over the warps turns the warp counts into the counts in
//      earlier warps (one thread a digit, 256 in parallel); each block's counts go to the
//      cluster through distributed shared memory (`map_shared_rank`), so a block learns the
//      window's total of each digit and the count in earlier blocks; every prefix over the 256
//      bins is a warp-shuffle scan (`scan_bins`).
//   3. Place: the round's lanes are sorted locally in shared memory (digit << 24 | lane),
//      then written out in that order, so each digit's run goes to consecutive slots and
//      neighbouring threads write neighbouring words.
// Where a block's share spans several rounds, each round is first ranked for its counts
// alone; then each round is read and ranked again, placed and written, and advances each
// digit's base by its count: the rounds go in lane order, so the order stays stable.  Every
// block, also one with no lanes, reaches both cluster barriers.
//
// Why ballots: `__match_any_sync`, which the atomic form (`bench/csrc/zk_msm_window_atomic.cu`)
// and the first cut of this one used, costs more the more distinct digits a warp holds, so
// the ranks cost more at random digits than at {0, 1}; eight ballots cost the same at any
// digits (PERF.md).
//
// What bounds it.  The bytes are small: the scalars (32 B a lane) read once and 8 B a lane
// and window written, 4.7 MB at m = 16,384, 0.0014 ms at 3.35 TB/s, under the ~0.005 ms that
// any launch takes.  But a window reads one byte of each lane's 32-byte sector, so the 32
// windows pull every sector through L2 32 times (16 MB at m = 16,384, 128 MB at 2^17), and
// that traffic and the latency of the barriers and of a warp's chain of passes are what
// cost.  A cluster of kCluster blocks a window spreads the loads and stores over kCluster
// times more SMs than one block a window; the sizes were chosen by a sweep (PERF.md).
//
// C interface (loaded with ctypes by protocol_tpu_torch/ops/_build.py):
//     int zk_msm_window(scalars, ds, perm, m, stream)
// scalars (m, 4) uint64, ds and perm (32, m) int32; launches on `stream` and returns
// cudaGetLastError() (0 on success), or the error of raising the shared-memory limit.
#include <cooperative_groups.h>
#include <cstdint>

#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kWindows = 32;
constexpr int kBins = 256;
constexpr int kCluster = 8;  // blocks a window
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRound = 16384;  // lanes a block sorts in shared memory at once
constexpr unsigned kFull = 0xffffffffu;

static_assert(kThreads % 32 == 0 && kThreads >= kBins && kThreads <= 1024, "block size");
static_assert(kRound <= 1 << 16, "a rank must fit 16 bits");

// Lanes a block holds in shared memory: one round of the largest share.
__host__ __device__ long long capacity(long long m) {
  const long long share = (m + kCluster - 1) / kCluster;
  return share < kRound ? share : kRound;
}

// Exclusive prefixes over the bins of two values at once: thread t < kBins passes bin t's
// pair and gets the sums of the bins before it (other threads pass zeros and get nothing of
// use).  Every thread calls it.
__device__ int2 scan_bins(int2 v, int2* part) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int2 x = v;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int yx = __shfl_up_sync(kFull, x.x, o), yy = __shfl_up_sync(kFull, x.y, o);
    if (lane >= o) x = make_int2(x.x + yx, x.y + yy);
  }
  if (lane == 31 && warp < kBins / 32) part[warp] = x;
  __syncthreads();
  int2 before = make_int2(x.x - v.x, x.y - v.y);
#pragma unroll
  for (int k = 0; k < kBins / 32; ++k) {
    if (k < warp) before = make_int2(before.x + part[k].x, before.y + part[k].y);
  }
  __syncthreads();  // `part` may be written again
  return before;
}

// Lanes a warp ranks in a round of n: warp j takes round lanes [j * chunk, (j + 1) * chunk).
__device__ int warp_chunk(int n) { return (n + kThreads - 1) / kThreads * 32; }

// Round lanes [lo, lo + n) of window w: keys[i] becomes digit << 16 | the rank of round lane
// i among its warp's earlier lanes of the same digit, and woff[j][d] warp j's count of d.
__device__ void rank_round(const uint8_t* __restrict__ bytes, int w, long long lo, int n,
                           int* keys, int (*woff)[kBins]) {
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  for (int i = t; i < kWarps * kBins; i += kThreads) woff[i / kBins][i % kBins] = 0;
#pragma unroll 4
  for (int i = t; i < n; i += kThreads) keys[i] = bytes[(lo + i) * 32 + w];
  __syncthreads();
  const int chunk = warp_chunk(n);
  const int end = (warp + 1) * chunk < n ? (warp + 1) * chunk : n;
  const unsigned below = (1u << lane) - 1u;
  for (int b = warp * chunk; b < end; b += 32) {
    const int i = b + lane;
    const bool valid = i < end;
    const int d = valid ? keys[i] : 0;
    // The lanes of this pass with d's digit: one ballot a bit, and valid lanes only.
    unsigned peers = __ballot_sync(kFull, valid);
#pragma unroll
    for (int bit = 0; bit < 8; ++bit) {
      const unsigned ones = __ballot_sync(kFull, (d >> bit) & 1);
      peers &= (d >> bit) & 1 ? ones : ~ones;
    }
    const int first = __ffs(peers) - 1;
    int seen = valid && lane == first ? woff[warp][d] : 0;
    seen = __shfl_sync(kFull, seen, valid ? first : lane);
    if (valid) {
      keys[i] = d << 16 | (seen + __popc(peers & below));
      if (lane == first) woff[warp][d] = seen + __popc(peers);
    }
    __syncwarp();
  }
  __syncthreads();
}

// Per digit (thread t < kBins) the warp counts become the counts in earlier warps; returns
// the round's count of digit t.
__device__ int warp_offsets(int (*woff)[kBins]) {
  int run = 0;
  if (threadIdx.x < kBins) {
#pragma unroll 8
    for (int j = 0; j < kWarps; ++j) {
      const int c = woff[j][threadIdx.x];
      woff[j][threadIdx.x] = run;
      run += c;
    }
  }
  return run;
}

__global__ void __cluster_dims__(kCluster, 1, 1) __launch_bounds__(kThreads)
msm_window_kernel(const uint8_t* __restrict__ bytes, int* __restrict__ ds,
                  int* __restrict__ perm, long long m) {
  extern __shared__ int keys[];  // the round's digit << 16 | rank, then `sorted`
  __shared__ int woff[kWarps][kBins];
  __shared__ int bcnt[kBins];   // the block's count of each digit over its share
  __shared__ int start[kBins];  // each digit's first place in `sorted`
  __shared__ int base[kBins];   // each digit's next slot in the window's output
  __shared__ int2 part[kBins / 32];
  uint32_t* sorted = reinterpret_cast<uint32_t*>(keys + capacity(m));  // d << 24 | round lane
  cg::cluster_group cluster = cg::this_cluster();
  const int t = threadIdx.x, w = blockIdx.y;
  const int rank = static_cast<int>(cluster.block_rank());
  const long long share = (m + kCluster - 1) / kCluster;
  const long long lo = rank * share < m ? rank * share : m;
  const long long hi = lo + share < m ? lo + share : m;
  const bool one_round = hi - lo <= kRound;

  // The block's count of each digit over its share: each round ranked in turn.  A share of
  // one round keeps its ranks and offsets for the placement below.
  int n = 0, count = 0, all = 0;  // the round's lanes; the round's and the share's count of t
  for (long long rlo = lo; rlo < hi; rlo += kRound) {
    n = static_cast<int>(hi - rlo < kRound ? hi - rlo : kRound);
    rank_round(bytes, w, rlo, n, keys, woff);
    count = warp_offsets(woff);
    all += count;
    if (!one_round) __syncthreads();  // the next round clears `woff`
  }
  if (t < kBins) bcnt[t] = all;
  cluster.sync();  // every block's counts are in place
  int before = 0, total = 0;
  if (t < kBins) {
#pragma unroll
    for (int r = 0; r < kCluster; ++r) {
      const int c = *cluster.map_shared_rank(bcnt + t, r);
      total += c;
      before += r < rank ? c : 0;
    }
  }
  // Done reading the cluster's counts; the matching wait at the end keeps every block's
  // shared memory alive until all have read it.
  asm volatile("barrier.cluster.arrive.release.aligned;" ::: "memory");
  int2 firsts = scan_bins(make_int2(total, count), part);  // .y: this round's starts
  if (t < kBins) base[t] = firsts.x + before;

  int* ds_w = ds + static_cast<long long>(w) * m;
  int* perm_w = perm + static_cast<long long>(w) * m;
  for (long long rlo = lo; rlo < hi; rlo += kRound) {
    if (!one_round) {
      n = static_cast<int>(hi - rlo < kRound ? hi - rlo : kRound);
      rank_round(bytes, w, rlo, n, keys, woff);
      count = warp_offsets(woff);
      firsts = scan_bins(make_int2(0, count), part);
    }
    if (t < kBins) start[t] = firsts.y;
    __syncthreads();
    // The local sort: each lane to its place in digit order.
    const int chunk = warp_chunk(n);
    for (int i = t; i < n; i += kThreads) {
      const int v = keys[i], d = v >> 16;
      sorted[start[d] + woff[i / chunk][d] + (v & 0xffff)] = static_cast<uint32_t>(d) << 24 | i;
    }
    __syncthreads();
    // Each digit's run to its slots, neighbouring threads on neighbouring words.
    for (int p = t; p < n; p += kThreads) {
      const uint32_t v = sorted[p];
      const int d = static_cast<int>(v >> 24);
      const long long slot = base[d] + (p - start[d]);
      ds_w[slot] = d;
      perm_w[slot] = static_cast<int>(rlo + (v & 0xffffffu));
    }
    __syncthreads();
    if (t < kBins) base[t] += count;
  }
  asm volatile("barrier.cluster.wait.acquire.aligned;" ::: "memory");
}

}  // namespace

extern "C" int zk_msm_window(const uint64_t* scalars, int* ds, int* perm, long long m,
                             void* stream) {
  if (m <= 0) return 0;
  // `keys` and `sorted`, 4 B a lane each, hold one round of the largest share.
  const int smem = static_cast<int>(capacity(m) * 2 * sizeof(int));
  cudaError_t err = cudaFuncSetAttribute(msm_window_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  msm_window_kernel<<<dim3(kCluster, kWindows), kThreads, smem,
                      static_cast<cudaStream_t>(stream)>>>(
      reinterpret_cast<const uint8_t*>(scalars), ds, perm, m);
  return static_cast<int>(cudaGetLastError());
}
