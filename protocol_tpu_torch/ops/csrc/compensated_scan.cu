// Compensated (TwoSum) inclusive prefix sum of `rowsum_sorted`'s block totals, on Hopper.
//
// Replaces the jit'd XLA passes `protocol_tpu/ops/sparse.py:120`, the block totals
// `wh[:, -1] + wl[:, -1]`, and `_compensated_cumsum` at :41 (part of ROADMAP B4), which is
// `lax.associative_scan(two_sum, (x, 0))` over them.  Neither is a Pallas kernel in the
// reference; the port's plain version, `_block_total_scan` in
// protocol_tpu_torch/ops/sparse.py, composes the same two steps in PyTorch.
//
// The totals.  Block r's total is x[r] = wh[r*B + B - 1] + wl[r*B + B - 1] (one __fadd_rn,
// PyTorch's float add), read here from the prefix lanes, so no other launch builds them.
//
// The recursion, scan(A) for a level A of m (hi, lo) pairs:
//   - m < 2: A itself, untouched;
//   - R[i] = two_sum(A[2i], A[2i+1]) for i < m/2, S' = scan(R);
//   - S[0] = A[0], S[2j] = two_sum(S'[j-1], A[2j]) for 2j < m,
//     S[2j+1] = S'[j];
//   - every S[i] then gets + 0.0 on both lanes (the associative scan's
//     pad-and-add interleave), which turns -0.0 into +0.0.
// two_sum is TwoSum on the hi lanes with lo = (a_lo + b_lo) + err and no
// renormalisation; it is not the row prefix's ds_add.  Level 0 is x with lo = +0.0,
// level k has n_k = n >> k elements, and level-k element i covers x[i*2^k, (i+1)*2^k).
// Element i of level k+1 is the pair (2i, 2i+1) of level k, which exists exactly when
// i < n >> (k+1).  Level K, the first with n_K < 2, is its own scan.
//
// Iterative form: chunks of eight.  A chunk is 8 consecutive elements of a level k, chunk
// q holding elements 8q .. 8q+7; its pair tree (levels k+1, k+2 and the one element
// 8q..8q+7 stands for on level k+3) is held in registers by one thread, which computes
// every pair without asking which exist: an absent element is read as +0.0 and what it
// feeds is never read.  Its down-sweep needs two elements of the scan of level k+3: S[q]
// (own) and S[q-1] (prev).  Where the rule S[2j] reaches back past the chunk, the element
// it needs is the last odd element of the chunk before, which the recursion makes
// pz(S[q-1]) one level down, pz of that the next level down, and so on (pz: + 0.0 on both
// lanes).  Each level takes the base case where n_k < 2.
//
// One cluster of 8 blocks (Hopper's thread block clusters) runs the scan, so that the
// lane reads, one 32-byte sector of each lane a total, are spread over 8 SMs: one SM
// takes about one such scattered sector a clock, so a single block spent most of its
// time reading.  Each thread takes at most one chunk.
//   1. Up from the lanes: each thread builds its chunk's tree from 8^D totals (D = 1 while
//      n >> 3 <= 4095, one more level of chunks of eight for every factor 8 above; the
//      D >= 2 forms compute the lower levels anew where they need them instead of storing
//      them) and keeps it in registers.
//   2. Each chunk's level-3D element goes into the shared memory of all 8 blocks (the
//      cluster's distributed shared memory), between two cluster barriers.
//   3. Up in shared memory, every block on its own copy: chunks of eight of each level,
//      three levels at a time, each level written behind the one below, until a level
//      has fewer than two elements.
//   4. Down in shared memory, top to bottom: each chunk's scan replaces the chunk in place
//      (a thread reads only its own chunk and the level above, which no one writes then).
//   5. Down to the outputs: each thread's scan of its chunk from the tree in registers,
//      written to hi/lo, eight floats a lane as two float4s.
// A barrier separates the passes; there is no scratch in device memory.
//
// Op order is the contract: every add and subtract is __fadd_rn / __fsub_rn in two_sum's
// order, the interleave's + 0.0 is an explicit __fadd_rn(v, 0.0f) the compiler cannot
// drop, and the source is never built with --use_fast_math or -ftz=true.
//
// What bounds it.  In bytes almost nothing: one 32-byte sector of each lane a total read
// and 8 B written, ~1.7 MB at the 24,415 totals of the headline's CSR step.  The
// recursion is one tree, so one cluster: the lane reads (~6,100 scattered sectors an SM
// at 24,415 totals), two cluster barriers, ~2 log2(n) / 3 block-barrier passes in shared
// memory and the launch itself bound it.  The design keeps three levels a pass in
// registers, never touches device memory between the passes, and reads its input from
// the lanes, which retires the totals' own PyTorch launch.
//
// C interface (loaded with ctypes by protocol_tpu_torch/ops/_build.py):
//     int compensated_scan(wh, wl, hi, lo, n, block, stream)
// with wh, wl float32 lanes of n rows of `block`; hi, lo n floats each, 16-byte aligned.
// Launches on `stream` and returns cudaGetLastError() (0 on success).

#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

// Blocks of the cluster and threads a block: one chunk a thread at most.
constexpr int kCluster = 8;
constexpr int kThreads = 512;
// Most elements of the first level held in shared memory, and the pairs the levels above
// it add: 4095 + 511 + 63 + 7.  A level of 4,095 elements comes from at most 4,096
// chunks, 512 a block.
constexpr long long kSharedLevel = 4095;
constexpr int kSharedPairs = 4676;
// Depths D the launcher instantiates: n < 4096 * 8^8 covers every float32 tensor that
// fits one card.
constexpr int kMaxDepth = 8;

__device__ __forceinline__ float2 two_sum(float2 a, float2 b) {
  const float s = __fadd_rn(a.x, b.x);
  const float bb = __fsub_rn(s, a.x);
  const float err = __fadd_rn(__fsub_rn(a.x, __fsub_rn(s, bb)), __fsub_rn(b.x, bb));
  return make_float2(s, __fadd_rn(__fadd_rn(a.y, b.y), err));
}

__device__ __forceinline__ float2 plus_zero(float2 a) {
  return make_float2(__fadd_rn(a.x, 0.0f), __fadd_rn(a.y, 0.0f));
}

// A chunk: its eight level-k elements and their pair tree.
struct Tree {
  float2 a[8], t1[4], t2[2], t3;
};

__device__ __forceinline__ void tree_up(Tree& t) {
#pragma unroll
  for (int i = 0; i < 4; ++i) t.t1[i] = two_sum(t.a[2 * i], t.a[2 * i + 1]);
#pragma unroll
  for (int i = 0; i < 2; ++i) t.t2[i] = two_sum(t.t1[2 * i], t.t1[2 * i + 1]);
  t.t3 = two_sum(t.t2[0], t.t2[1]);
}

// One level of a chunk's down-sweep: the scan s of its 2M elements a of a level with n_k
// elements, from the scan sup of their M pairs and `before`, the scan of the element
// before the chunk one level up; `first`: the chunk starts the level.
template <int M>
__device__ __forceinline__ void level_down(const float2 (&a)[2 * M], const float2 (&sup)[M],
                                           float2 before, bool first, long long n_k,
                                           float2 (&s)[2 * M]) {
  if (n_k < 2) {  // the recursion's base case: the level, untouched
#pragma unroll
    for (int i = 0; i < 2 * M; ++i) s[i] = a[i];
    return;
  }
#pragma unroll
  for (int e = 0; e < M; ++e) {
    const float2 left = e == 0 ? before : sup[e - 1];
    s[2 * e] = plus_zero(e == 0 && first ? a[0] : two_sum(left, a[2 * e]));
    s[2 * e + 1] = plus_zero(sup[e]);
  }
}

// The scan s of chunk q's eight level-k elements from own = S_{k+3}[q] and
// prev = S_{k+3}[q-1] (unread for q = 0); `before` comes back as S_k[8q - 1].
__device__ __forceinline__ void tree_down(const Tree& t, long long q, int k, long long n,
                                          float2 prev, float2 own, float2 (&s)[8],
                                          float2& before) {
  const bool first = q == 0;
  const float2 top[1] = {own};
  float2 s2[2], s1[4];
  level_down<1>(t.t2, top, prev, first, n >> (k + 2), s2);
  prev = plus_zero(prev);  // S_{k+2}[2q - 1]
  level_down<2>(t.t1, s2, prev, first, n >> (k + 1), s1);
  prev = plus_zero(prev);  // S_{k+1}[4q - 1]
  level_down<4>(t.a, s1, prev, first, n >> k, s);
  before = plus_zero(prev);  // S_k[8q - 1]
}

struct Lanes {
  const float* wh;
  const float* wl;
  long long block, n;
};

struct Out {
  float* hi;
  float* lo;
};

// Block total i, lo = +0.0; past the last block +0.0.
__device__ __forceinline__ float2 total(const Lanes& x, long long i) {
  if (i >= x.n) return make_float2(0.0f, 0.0f);
  const long long at = i * x.block + x.block - 1;
  return make_float2(__fadd_rn(x.wh[at], x.wl[at]), 0.0f);
}

template <int D>
__device__ __forceinline__ float2 up(const Lanes& x, long long q);

template <int D>
__device__ __noinline__ float2 up_call(const Lanes& x, long long q) {
  return up<D>(x, q);
}

// Chunk q's eight level-3(D-1) elements: totals for D = 1, else each the pair tree of a
// chunk one depth down, computed anew.
template <int D>
__device__ __forceinline__ void fill(const Lanes& x, long long q, Tree& t) {
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    if constexpr (D == 1) {
      t.a[i] = total(x, 8 * q + i);
    } else {
      t.a[i] = up_call<D - 1>(x, 8 * q + i);
    }
  }
}

// The level-3D element that chunk q of depth D stands for.
template <int D>
__device__ __forceinline__ float2 up(const Lanes& x, long long q) {
  Tree t;
  fill<D>(x, q, t);
  tree_up(t);
  return t.t3;
}

template <int D>
__device__ __forceinline__ void down(const Lanes& x, const Out& o, long long q, const Tree& t,
                                     float2 prev, float2 own);

// Chunk q of depth D, its tree built anew, down to the outputs.
template <int D>
__device__ __noinline__ void down_call(const Lanes& x, const Out& o, long long q, float2 prev,
                                       float2 own) {
  Tree t;
  fill<D>(x, q, t);
  tree_up(t);
  down<D>(x, o, q, t, prev, own);
}

// The scan of chunk q of depth D, tree t, to the outputs, from S_{3D}[q] (own) and
// S_{3D}[q-1] (prev).
template <int D>
__device__ __forceinline__ void down(const Lanes& x, const Out& o, long long q, const Tree& t,
                                     float2 prev, float2 own) {
  float2 s[8], before;
  tree_down(t, q, 3 * (D - 1), x.n, prev, own, s, before);
  if constexpr (D == 1) {
    const long long base = 8 * q;
    if (base + 8 <= x.n) {
      float4* hi = reinterpret_cast<float4*>(o.hi + base);
      float4* lo = reinterpret_cast<float4*>(o.lo + base);
      hi[0] = make_float4(s[0].x, s[1].x, s[2].x, s[3].x);
      hi[1] = make_float4(s[4].x, s[5].x, s[6].x, s[7].x);
      lo[0] = make_float4(s[0].y, s[1].y, s[2].y, s[3].y);
      lo[1] = make_float4(s[4].y, s[5].y, s[6].y, s[7].y);
    } else {
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        if (base + i < x.n) {
          o.hi[base + i] = s[i].x;
          o.lo[base + i] = s[i].y;
        }
      }
    }
  } else {
    long long span = 1;  // totals in a chunk of depth D - 1
#pragma unroll
    for (int d = 1; d < D; ++d) span *= 8;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const long long r = 8 * q + i;
      if (r * span < x.n) down_call<D - 1>(x, o, r, i == 0 ? before : s[i - 1], s[i]);
    }
  }
}

template <int D>
__global__ void __cluster_dims__(kCluster, 1, 1) __launch_bounds__(kThreads)
compensated_scan_kernel(Lanes x, Out o) {
  __shared__ float2 lv[kSharedPairs];  // levels 3D, 3D + 3, ... back to back
  cg::cluster_group cluster = cg::this_cluster();
  const int t = threadIdx.x;
  const float2 zero = make_float2(0.0f, 0.0f);
  long long span = 1;  // totals in a chunk of depth D
#pragma unroll
  for (int d = 0; d < D; ++d) span *= 8;
  const long long chunks = (x.n + span - 1) / span;  // <= kSharedLevel + 1
  const long long per_block = (chunks + kCluster - 1) / kCluster;  // <= kThreads
  const long long q = cluster.block_rank() * per_block + t;  // this thread's chunk
  const bool mine = t < per_block && q < chunks;
  const int n_top = static_cast<int>(x.n >> (3 * D));  // <= kSharedLevel

  // 1. Up from the lanes: the chunk's tree stays in registers until step 5.
  Tree tree;
  if (mine) {
    fill<D>(x, q, tree);
    tree_up(tree);
  }
  cluster.sync();  // every block of the cluster runs: its shared memory takes writes

  // 2. Level 3D into the shared memory of every block of the cluster.
  if (mine && q < n_top) {
#pragma unroll
    for (int r = 0; r < kCluster; ++r) *cluster.map_shared_rank(lv + q, r) = tree.t3;
  }
  cluster.sync();

  // 3. Up in shared memory, each block on its own copy: level k (m elements at `off`)
  //    gives level k + 3 behind it.
  int off = 0, m = n_top, k = 3 * D, passes = 0;
  while (m >= 2) {
    const int next = m >> 3;
    for (int c = t; 8 * c < m; c += kThreads) {
      Tree tr;
#pragma unroll
      for (int i = 0; i < 8; ++i) tr.a[i] = 8 * c + i < m ? lv[off + 8 * c + i] : zero;
      tree_up(tr);
      if (c < next) lv[off + m + c] = tr.t3;
    }
    __syncthreads();
    off += m;
    m = next;
    k += 3;
    ++passes;
  }

  // 4. Down in shared memory; the top level (m < 2) is its own scan.
  for (; passes > 0; --passes) {
    const int above = off;
    k -= 3;
    m = static_cast<int>(x.n >> k);
    off -= m;
    for (int c = t; 8 * c < m; c += kThreads) {
      Tree tr;
#pragma unroll
      for (int i = 0; i < 8; ++i) tr.a[i] = 8 * c + i < m ? lv[off + 8 * c + i] : zero;
      tree_up(tr);
      const float2 prev = c > 0 ? lv[above + c - 1] : zero;
      const float2 own = c < (m >> 3) ? lv[above + c] : zero;
      float2 s[8], before;
      tree_down(tr, c, k, x.n, prev, own, s, before);
#pragma unroll
      for (int i = 0; i < 8; ++i)
        if (8 * c + i < m) lv[off + 8 * c + i] = s[i];
    }
    __syncthreads();
  }

  // 5. Down to the outputs.
  if (mine) down<D>(x, o, q, tree, q > 0 ? lv[q - 1] : zero, q < n_top ? lv[q] : zero);
}

template <int D>
int launch(const Lanes& x, const Out& o, cudaStream_t stream) {
  if constexpr (D > kMaxDepth) {
    return static_cast<int>(cudaErrorInvalidValue);
  } else {
    if ((x.n >> (3 * D)) > kSharedLevel) return launch<D + 1>(x, o, stream);
    compensated_scan_kernel<D><<<kCluster, kThreads, 0, stream>>>(x, o);
    return static_cast<int>(cudaGetLastError());
  }
}

}  // namespace

extern "C" int compensated_scan(const void* wh, const void* wl, void* hi, void* lo, long long n,
                                long long block, void* stream) {
  if (n <= 0) return 0;
  if (block <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const Lanes x{static_cast<const float*>(wh), static_cast<const float*>(wl), block, n};
  const Out o{static_cast<float*>(hi), static_cast<float*>(lo)};
  return launch<1>(x, o, static_cast<cudaStream_t>(stream));
}
