// K13: the Pippenger MSM's bucket sums, on Hopper: two launches.
//
// Replaces `protocol_tpu/zk/graft/pippenger.py:150` `fold` and `:166` `carry`
// (`zk-graft-msm-scan`, over `protocol_tpu/ops/segments.py:38` `segmented_carry_scan`,
// `:20` `run_end_mask`, `:30` `block_boundary_flags`) and `:171` `bucket`
// (`zk-graft-msm-bucket`), with `_jadd` :81 and `_jdbl` :58.  From K12's sorted digits
// `ds` and order `perm` (32, m) it computes every (window, digit) bucket, the sum of the
// points whose scalar has that digit in that window, as (32, 256, 3, 4) uint64 words of
// canonical Jacobian Fq (out of the Montgomery domain; Z == 0 is an empty bucket, and
// empty buckets are written as zeros).  Bucket 0 and padding lanes (digit 0) are skipped,
// as the reference's `_finish` skips them: bucket 0 comes out empty.  The plain version
// is `protocol_tpu_torch/zk/graft/pippenger.py::_buckets_plain`, the reference's two
// levels; the two agree as points.
//
// What bounds it.  Operations: the function needs one mixed add (madd-2007-bl, 11
// Montgomery multiplies; the cache's points have Z = 1) for each non-zero lane past the
// first of its bucket: ~1.5 G 32-bit multiply-adds at m = 16,384 random scalars, ~0.089
// ms at the SM's integer rate, and almost none at {0, 1} scalars.  Bytes are a few MB
// (the digits, the order, 96-byte point reads from an L2-resident cache, 0.8 MB of
// buckets).  The first form (three launches: 16-lane chunks of complete adds, a
// block-wide segmented scan of the chunk tails on 32 blocks, then the run ends) took
// ~0.85 ms whatever the data: its fold and its carry each held ~0.4 ms, chains of
// dependent complete adds in warps too few to hide them, with the group law inlined into
// ~150-500 KB of code a kernel.
//
// The design:
//   1. piece (one thread a window and piece of 2^PIECE_LOG sorted lanes): sums each run
//      of one digit within its piece with mixed adds, the points read as points[perm[i]]
//      straight from the cache (a cache identity, Z == 0, is skipped; the next lane's
//      point is loaded while the current one is added).  A run that is a whole bucket
//      (its first and last lanes in this piece) is finished here: out of the Montgomery
//      domain into `out`.  A bucket that crosses a piece boundary leaves its partials:
//      the piece where it starts writes `tail[piece]`, every later piece it covers
//      `head[piece]`.  Joining by bucket identity keeps segments from leaking across
//      digits.  A thread's chain is at most 2^PIECE_LOG mixed adds, and a window's pieces
//      spread over the whole card.
//   2. join: finds each bucket's lanes by binary search in `ds`, writes zeros for an
//      empty bucket (and bucket 0), and adds tail[c1], head[c1 + 1], ..., head[c2] for a
//      bucket over k > 1 pieces: by 2^JOIN_LOG lanes of a warp, each lane its share in a
//      row, where k <= SMALL_K << JOIN_LOG; else (a skewed window: 8,192 lanes of digit 1
//      at {0, 1} scalars, or the top window of scalars below 2^254) by a block of its
//      own, log-deep.  Complete adds (add-2007-bl, 16 multiplies) throughout.
// Every loop over lanes or pieces runs the same count in all lanes of a warp, an identity
// past a lane's own share, with __syncwarp between the group law's steps, so the warp
// stays converged around the calls below.
// How it is compiled: the group law calls one `__noinline__` copy of the Fq multiply.
// Inlined, the two kernels held several times the code and more registers, and ran
// longer.  `nvcc -Xptxas -v`: piece 128 registers, join 96, no spills; the stack frames
// (480 and 1,120 bytes) hold the multiply's operands.
#include <cstdint>

#include <cuda_runtime.h>

#include "bn254_field.cuh"

namespace {

constexpr int WINDOWS = 32;
constexpr int BUCKETS = 256;
constexpr int WORDS = 12;  // a point: X, Y, Z of four words each
constexpr int PIECE_THREADS = 128;
constexpr int JOIN_THREADS = 128;
constexpr int JOIN_WARPS = JOIN_THREADS / 32;
// log2 of the sorted lanes a piece thread adds in a row (at most log2 m).
constexpr int PIECE_LOG = 4;
// log2 of the join lanes that add one bucket's pieces.
constexpr int JOIN_LOG = 1;
// Pieces a join lane adds in a row; a bucket over more than SMALL_K pieces a lane of its
// group is added by a block of its own.
constexpr long long SMALL_K = 8;

using bn254::Fe;
using bn254::Point;

__device__ __noinline__ Fe fq_mul(const Fe& a, const Fe& b) {
    return bn254::mont_mul<bn254::FQ>(a, b);
}

struct MulCalled {
    __device__ __forceinline__ static Fe mul(const Fe& a, const Fe& b) { return fq_mul(a, b); }
};

// The group law, inlined around calls of the one multiply.
__device__ __forceinline__ Point jadd(const Point& p, const Point& q) {
    return bn254::jadd<MulCalled>(p, q);
}
__device__ __forceinline__ Point madd(const Point& p, const Fe& x, const Fe& y, const Fe& z) {
    return bn254::madd<MulCalled>(p, x, y, z);
}

__device__ __forceinline__ Point identity() {
    Point p;
    p.x = bn254::zero();
    p.y = bn254::zero();
    p.z = bn254::zero();
    return p;
}

// A bucket sum out of the Montgomery domain into its slot of `out`.
__device__ __forceinline__ void store_bucket(uint64_t* o, const Point& b) {
    const Fe one{{1, 0, 0, 0, 0, 0, 0, 0}};
    bn254::store(o, fq_mul(b.x, one));
    bn254::store(o + 4, fq_mul(b.y, one));
    bn254::store(o + 8, fq_mul(b.z, one));
}

// The run of digit d over lanes [a, i) of the piece [s, e) is done: a whole bucket goes out,
// a partial to head (the run began in an earlier piece) or tail (it goes on in the next).
__device__ __forceinline__ void flush(const Point& acc, int d, long long a, long long i, long long s,
                                      long long e, int before, int after, long long gid, int w,
                                      uint64_t* head, uint64_t* tail, uint64_t* out) {
    if (d == 0) return;
    if (a == s && before == d) {
        bn254::store_point(head + WORDS * gid, acc);
    } else if (i == e && after == d) {
        bn254::store_point(tail + WORDS * gid, acc);
    } else {
        store_bucket(out + WORDS * ((long long)w * BUCKETS + d), acc);
    }
}

// Every thread of a warp walks its piece's 2^plog lanes (plog = PIECE_LOG, less where m is
// smaller) in step (the same count for all, so
// the warp stays converged around the group law's calls); the next lane's point is loaded
// while the current one is added.
__global__ void __launch_bounds__(PIECE_THREADS) msm_piece_kernel(
    const int* __restrict__ ds, const int* __restrict__ perm, const uint64_t* __restrict__ points,
    uint64_t* __restrict__ head, uint64_t* __restrict__ tail, uint64_t* __restrict__ out,
    long long m, int plog) {
    const long long npc = m >> plog;
    const long long gid = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    const bool live = gid < WINDOWS * npc;
    const long long g = live ? gid : 0;
    const int w = (int)(g / npc);
    const long long c = g % npc;
    const int* dw = ds + (long long)w * m;
    const int* pw = perm + (long long)w * m;
    const long long s = c << plog;
    const long long e = s + (1LL << plog);
    const int before = s > 0 ? dw[s - 1] : -1;
    const int after = e < m ? dw[e] : -1;
    Point acc = identity();
    int run = dw[s];
    long long a = s;
    const uint64_t* pt = points + (long long)WORDS * pw[s];
    Fe x = bn254::load(pt), y = bn254::load(pt + 4), z = bn254::load(pt + 8);
    for (long long i = s; i < e; ++i) {
        const int d = dw[i];
        const Fe cx = x, cy = y, cz = z;
        if (i + 1 < e) {
            pt = points + (long long)WORDS * pw[i + 1];
            x = bn254::load(pt);
            y = bn254::load(pt + 4);
            z = bn254::load(pt + 8);
        }
        if (d != run) {
            if (live) flush(acc, run, a, i, s, e, before, after, gid, w, head, tail, out);
            acc = identity();
            run = d;
            a = i;
        }
        __syncwarp();
        if (d != 0 && !bn254::is_zero(cz)) acc = madd(acc, cx, cy, cz);
        __syncwarp();
    }
    if (live) flush(acc, run, a, e, s, e, before, after, gid, w, head, tail, out);
}

// First lane of the sorted row `d` at or above value v.
__device__ __forceinline__ long long lower_bound(const int* d, long long m, int v) {
    long long lo = 0, hi = m;
    while (lo < hi) {
        const long long mid = (lo + hi) >> 1;
        if (d[mid] < v) lo = mid + 1;
        else hi = mid;
    }
    return lo;
}

// The same by a whole block in a few rounds: the block's threads read evenly spaced lanes
// of the current range at once and keep the stretch where the row crosses v.
__device__ __forceinline__ long long block_lower_bound(const int* d, long long m, int v) {
    const int t = threadIdx.x;
    const int nt = blockDim.x;
    long long base = 0, len = m;  // the answer lies in [base, base + len]
    while (true) {
        const long long step = (len + nt - 1) / nt;
        const long long pos = base + (long long)t * step;
        const int c = __syncthreads_count(pos < base + len && d[pos] < v);
        if (c == 0) return base;
        const long long next = base + (long long)(c - 1) * step + 1;
        if (step == 1) return next;
        const long long end = base + (long long)c * step < base + len ? base + (long long)c * step
                                                                       : base + len;
        base = next;
        len = end - next;
    }
}

__device__ __forceinline__ Point shfl_down(const Point& p, int off, int width) {
    Point o;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
        o.x.v[j] = __shfl_down_sync(0xffffffffu, p.x.v[j], off, width);
        o.y.v[j] = __shfl_down_sync(0xffffffffu, p.y.v[j], off, width);
        o.z.v[j] = __shfl_down_sync(0xffffffffu, p.z.v[j], off, width);
    }
    return o;
}

// The sum of a group of `width` lanes into its first lane, sub its lane in the group
// (the other lanes' results are partial).  Every lane of the warp takes part.
__device__ __forceinline__ Point group_sum(Point acc, int sub, int width) {
#pragma unroll 1
    for (int off = width >> 1; off > 0; off >>= 1) {
        const Point o = shfl_down(acc, off, width);
        if (sub < off) acc = jadd(acc, o);
        __syncwarp();
    }
    return acc;
}

// Piece j of a bucket that starts in piece c1 of its window.
__device__ __forceinline__ Point piece(const uint64_t* head, const uint64_t* tail, long long c1,
                                       long long j) {
    return bn254::load_point(j == 0 ? tail + WORDS * c1 : head + WORDS * (c1 + j));
}

// The join's two roles, by block.  The first (32 * 256 << JOIN_LOG) / JOIN_THREADS blocks
// add the buckets over 2 .. SMALL_K << JOIN_LOG pieces, 2^JOIN_LOG lanes a bucket, each lane
// its pieces sub, sub + 2^JOIN_LOG, ... in a row (the warp in step: every lane as many adds
// as its busiest lane, an identity past its own), then a shuffle tree in the group.  Each
// later block
// takes one (window, digit) and, where its bucket covers more pieces (a skewed window),
// adds them with all its threads: a stride of pieces a thread, a shuffle tree in each
// warp, one across the warps.  It leaves as soon as it sees a smaller bucket, so large
// buckets are added side by side, each on a block of its own.
__global__ void __launch_bounds__(JOIN_THREADS) msm_join_kernel(
    const int* __restrict__ ds, const uint64_t* __restrict__ head,
    const uint64_t* __restrict__ tail, uint64_t* __restrict__ out, long long m, int plog) {
    __shared__ uint32_t part[JOIN_WARPS][3 * 8];
    const int t = threadIdx.x;
    const int lane = t & 31;
    constexpr int glog = JOIN_LOG;
    constexpr int g = 1 << glog;
    const long long npc = m >> plog;
    const int small_blocks = (WINDOWS * BUCKETS << glog) / JOIN_THREADS;
    const bool large = (int)blockIdx.x >= small_blocks;
    const int sub = large ? 0 : t & (g - 1);
    const int slot = large ? (int)blockIdx.x - small_blocks
                           : (int)blockIdx.x * (JOIN_THREADS >> glog) + (t >> glog);
    const int w = slot / BUCKETS;
    const int d = slot % BUCKETS;
    const int* dw = ds + (long long)w * m;
    const uint64_t* hw = head + (long long)WORDS * w * npc;
    const uint64_t* tw = tail + (long long)WORDS * w * npc;
    uint64_t* o = out + (long long)WORDS * slot;
    long long lo = 0, hi = 0;
    if (large) {
        if (d != 0) {  // the same for the whole block
            lo = block_lower_bound(dw, m, d);
            hi = block_lower_bound(dw, m, d + 1);
        }
    } else if (d != 0) {
        lo = lower_bound(dw, m, d);
        hi = lower_bound(dw, m, d + 1);
    }
    const long long c1 = lo >> plog;
    // Pieces; 1: the piece kernel wrote the bucket.
    const long long k = lo == hi ? 0 : ((hi - 1) >> plog) - c1 + 1;
    const bool small = k > 1 && k <= (SMALL_K << glog);
    if (!large) {
        if (k == 0 && sub == 0) {
#pragma unroll
            for (int q = 0; q < WORDS; ++q) o[q] = 0;
        }
        const int mine = small ? (int)((k - sub + g - 1) >> glog) : 0;
        const int rounds = __reduce_max_sync(0xffffffffu, (unsigned)mine);
        Point acc = identity();
        for (int r = 0; r < rounds; ++r) {
            const Point p = r < mine ? piece(hw, tw, c1, sub + ((long long)r << glog)) : identity();
            acc = jadd(acc, p);
            __syncwarp();
        }
        acc = group_sum(acc, sub, g);
        if (small && sub == 0) store_bucket(o, acc);
        return;
    }
    if (k <= (SMALL_K << glog)) return;  // the whole block: k is the block's one bucket's
    Point sum = identity();
    for (long long j0 = 0; j0 < k; j0 += JOIN_THREADS) {
        const long long j = j0 + t;
        sum = jadd(sum, j < k ? piece(hw, tw, c1, j) : identity());
        __syncwarp();
    }
    sum = group_sum(sum, lane, 32);
    if (lane == 0) {
#pragma unroll
        for (int j = 0; j < 8; ++j) {
            part[t >> 5][j] = sum.x.v[j];
            part[t >> 5][8 + j] = sum.y.v[j];
            part[t >> 5][16 + j] = sum.z.v[j];
        }
    }
    __syncthreads();
    if (t < 32) {
        Point q = identity();
        if (lane < JOIN_WARPS) {
#pragma unroll
            for (int j = 0; j < 8; ++j) {
                q.x.v[j] = part[lane][j];
                q.y.v[j] = part[lane][8 + j];
                q.z.v[j] = part[lane][16 + j];
            }
        }
        q = group_sum(q, lane, 32);
        if (lane == 0) store_bucket(o, q);
    }
}

}  // namespace

// ds, perm: (32, m) int32 from K12, m a power of two; points: the point cache's (>= m, 3, 4)
// words; head and tail: (32, m >> min(PIECE_LOG, log2 m), 3, 4) scratch; out (32, 256, 3, 4).
extern "C" int zk_msm_bucket(const int* ds, const int* perm, const uint64_t* points,
                             uint64_t* head, uint64_t* tail, uint64_t* out, long long m,
                             void* stream) {
    if (m <= 0 || (m & (m - 1))) return (int)cudaErrorInvalidValue;
    int plog = 0;
    while (plog < PIECE_LOG && (2LL << plog) <= m) ++plog;
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    const long long threads = WINDOWS * (m >> plog);
    msm_piece_kernel<<<(unsigned)((threads + PIECE_THREADS - 1) / PIECE_THREADS), PIECE_THREADS,
                       0, s>>>(ds, perm, points, head, tail, out, m, plog);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    msm_join_kernel<<<(WINDOWS * BUCKETS << JOIN_LOG) / JOIN_THREADS + WINDOWS * BUCKETS,
                      JOIN_THREADS, 0, s>>>(ds, head, tail, out, m, plog);
    return (int)cudaGetLastError();
}
