// A yardstick, off the main path: the first form of the MSM's bucket sums (K13), three
// launches over fixed 16-lane chunks and a block-wide segmented scan of the chunk tails,
// exported as zk_msm_bucket_chunked.  protocol_tpu_torch/ops/csrc/zk_msm_bucket.cu replaced
// it; chip_smoke.py and bench/probe_graft_forms.py time it beside that kernel; the port never
// calls it.  Below, the source as it stood on the main path.
//
// K13: the Pippenger MSM's bucket sums, on Hopper: three launches.
//
// Replaces `protocol_tpu/zk/graft/pippenger.py:150` `fold` and `:166` `carry`
// (`zk-graft-msm-scan`, over `protocol_tpu/ops/segments.py:38` `segmented_carry_scan`,
// `:20` `run_end_mask`, `:30` `block_boundary_flags`) and `:171` `bucket`
// (`zk-graft-msm-bucket`), with `_jadd` :81 and `_jdbl` :58.  From K12's sorted digits
// `ds` and order `perm` (32, m) it computes every (window, digit) bucket, the sum of the
// points whose scalar has that digit in that window, as (32, 256, 3, 4) uint64 words of
// canonical Jacobian Fq (out of the Montgomery domain; Z == 0 is an empty bucket).
// Bucket 0 and padding lanes (digit 0) are skipped, as the reference's `_finish` skips
// them: bucket 0 comes out empty.  The plain version is
// `protocol_tpu_torch/zk/graft/pippenger.py::_buckets_plain`, the reference's two levels.
//
// The reference's load balance is kept: fixed chunks of `ch` sorted lanes a thread.
//   1. fold (one thread a window and chunk): adds the chunk's points, read as
//      points[perm[i]] straight from the point cache, run by run; at each run end it
//      writes the run's partial to its bucket slot `loc` and notes in `carry_from` the
//      chunk whose carry the bucket still needs (c - 1 when the chunk's first run began
//      in an earlier chunk, else -1); it writes the chunk's tail (the running sum at its
//      last lane) and the chunk's segment flag.
//   2. carry (one block a window, T <= 256 threads of nch / T chunks each): the
//      segmented inclusive scan of the tails, C[c] = tail[c] where chunk c starts a
//      segment, else C[c - 1] + tail[c]: sequential over a thread's chunks, then a
//      Hillis-Steele scan of the thread totals in shared memory (log2 T rounds), then
//      each thread's chunks before its first flag take the total before it.  In place.
//   3. bucket (one thread a window and digit): loc, plus C[carry_from] where it is set,
//      then out of the Montgomery domain.
// A chunk starts a segment where its first digit differs from its last or from the
// previous chunk's last.  The reference flags only the first case
// (`block_boundary_flags`), so a run that begins exactly at a block start and fills that
// block is carried together with the block before it, whose last run is another
// digit's; that bucket comes out wrong there (ROADMAP §C).
//
// What bounds it.  Operations: the function needs one mixed add (madd-2007-bl, 11
// Montgomery multiplies, 2,904 32-bit multiply-adds; the cache's points have Z = 1) for
// each non-zero lane past the first of its piece (a run within a chunk), and one full add
// (16 multiplies) to join each further piece of a bucket: ~1.5 G at m = 16,384 random
// scalars, against 0.09 ms at the SM's integer rate.  The fold adds with the complete
// jadd (16 multiplies) throughout, about 1.45 times that; bytes are a few MB (the digits,
// the order, 96-byte point reads from an L2-resident cache, 0.8 MB of buckets).  A
// thread's adds are a dependent chain, so short chunks (16 lanes) keep ~1,000 warps in
// flight at m = 16,384; the carry's log-depth scan keeps one thread from adding a whole
// skewed window (16k lanes of digit 1) in a row.
#include <cstdint>

#include <cuda_runtime.h>

#include "bn254_field.cuh"

namespace {

constexpr int WINDOWS = 32;
constexpr int BUCKETS = 256;
constexpr int WORDS = 12;  // a point: X, Y, Z of four words each
constexpr int MAX_CARRY_THREADS = 256;

using bn254::Point;

__device__ __forceinline__ Point identity() {
    Point p;
    p.x = bn254::zero();
    p.y = bn254::zero();
    p.z = bn254::zero();
    return p;
}

__global__ void __launch_bounds__(128) msm_fold_kernel(
    const int* __restrict__ ds, const int* __restrict__ perm, const uint64_t* __restrict__ points,
    uint64_t* __restrict__ tails, int* __restrict__ flags, uint64_t* __restrict__ loc,
    int* __restrict__ carry_from, long long m, int ch, int nch) {
    long long gid = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    if (gid >= (long long)WINDOWS * nch) return;
    const int w = (int)(gid / nch);
    const int c = (int)(gid % nch);
    const int* dw = ds + (long long)w * m;
    const int* pw = perm + (long long)w * m;
    const long long s = (long long)c * ch;
    const long long e = s + ch;
    const int first = dw[s];
    const int last = dw[e - 1];
    const int prev = c > 0 ? dw[s - 1] : -1;
    flags[gid] = (c == 0 || first != last || first != prev) ? 1 : 0;
    // The chunk's first run began in an earlier chunk: its bucket needs C[c - 1].
    const bool head_carries = c > 0 && first == prev;
    Point run = identity();
    int run_digit = -1;
    for (long long i = s; i < e; ++i) {
        const int d = dw[i];
        if (d != run_digit) {
            run = identity();
            run_digit = d;
        }
        if (d == 0) continue;
        run = bn254::jadd(run, bn254::load_point(points + (long long)WORDS * pw[i]));
        if (i + 1 == m || dw[i + 1] != d) {
            const long long slot = (long long)w * BUCKETS + d;
            bn254::store_point(loc + WORDS * slot, run);
            carry_from[slot] = (head_carries && d == first) ? c - 1 : -1;
        }
    }
    bn254::store_point(tails + WORDS * gid, run);
}

__global__ void __launch_bounds__(MAX_CARRY_THREADS) msm_carry_kernel(
    uint64_t* __restrict__ tails, const int* __restrict__ flags, int nch, int per) {
    __shared__ uint64_t total[MAX_CARRY_THREADS * WORDS];
    __shared__ int total_flag[MAX_CARRY_THREADS];
    const int t = threadIdx.x;
    const int nt = blockDim.x;
    uint64_t* tw = tails + (long long)blockIdx.x * nch * WORDS;
    const int* fw = flags + (long long)blockIdx.x * nch;
    // 1. Sequential over this thread's chunks (in place where there are several).
    Point acc = identity();
    int any = 0;
    for (int j = 0; j < per; ++j) {
        const int idx = t * per + j;
        const Point v = bn254::load_point(tw + (long long)WORDS * idx);
        const int f = fw[idx];
        acc = (j == 0 || f) ? v : bn254::jadd(acc, v);
        any |= f;
        if (per > 1) bn254::store_point(tw + (long long)WORDS * idx, acc);
    }
    bn254::store_point(total + WORDS * t, acc);
    total_flag[t] = any;
    __syncthreads();
    // 2. Segmented Hillis-Steele over the thread totals.
    for (int s = 1; s < nt; s <<= 1) {
        Point left;
        int left_flag = 0;
        bool active = false;
        if (t >= s) {
            left = bn254::load_point(total + WORDS * (t - s));
            left_flag = total_flag[t - s];
            active = !total_flag[t];
        }
        __syncthreads();
        if (active) {
            bn254::store_point(total + WORDS * t,
                               bn254::jadd(left, bn254::load_point(total + WORDS * t)));
        }
        if (t >= s) total_flag[t] |= left_flag;
        __syncthreads();
    }
    // 3. Back to the chunks.
    if (per == 1) {
        bn254::store_point(tw + (long long)WORDS * t, bn254::load_point(total + WORDS * t));
    } else if (t > 0) {
        const Point before = bn254::load_point(total + WORDS * (t - 1));
        for (int j = 0; j < per; ++j) {
            const int idx = t * per + j;
            if (fw[idx]) break;
            uint64_t* slot = tw + (long long)WORDS * idx;
            bn254::store_point(slot, bn254::jadd(before, bn254::load_point(slot)));
        }
    }
}

__global__ void __launch_bounds__(128) msm_bucket_kernel(const uint64_t* __restrict__ loc,
                                                         const int* __restrict__ carry_from,
                                                         const uint64_t* __restrict__ carries,
                                                         uint64_t* __restrict__ out, int nch) {
    const int gid = blockIdx.x * blockDim.x + threadIdx.x;
    if (gid >= WINDOWS * BUCKETS) return;
    const int w = gid / BUCKETS;
    const int d = gid % BUCKETS;
    const int cf = carry_from[gid];
    Point b = identity();
    if (d != 0 && cf != -2) {
        b = bn254::load_point(loc + (long long)WORDS * gid);
        if (cf >= 0) {
            b = bn254::jadd(b, bn254::load_point(carries + (long long)WORDS * ((long long)w * nch + cf)));
        }
    }
    uint64_t* o = out + (long long)WORDS * gid;
    bn254::store(o, bn254::from_mont<bn254::FQ>(b.x));
    bn254::store(o + 4, bn254::from_mont<bn254::FQ>(b.y));
    bn254::store(o + 8, bn254::from_mont<bn254::FQ>(b.z));
}

}  // namespace

// ds, perm: (32, m) int32 from K12; points: the point cache's (>= m, 3, 4) words;
// tails (32, nch, 3, 4) and flags (32, nch) scratch, nch = m / ch; loc (32, 256, 3, 4)
// scratch; carry_from (32, 256) int32 filled with -2 (no run end yet); out (32, 256, 3, 4).
extern "C" int zk_msm_bucket_chunked(const int* ds, const int* perm, const uint64_t* points,
                             uint64_t* tails, int* flags, uint64_t* loc, int* carry_from,
                             uint64_t* out, long long m, long long ch, void* stream) {
    if (m <= 0 || ch <= 0 || m % ch) return (int)cudaErrorInvalidValue;
    const long long nch = m / ch;
    if (nch & (nch - 1)) return (int)cudaErrorInvalidValue;
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    const int nt = (int)(nch < MAX_CARRY_THREADS ? nch : MAX_CARRY_THREADS);
    const int per = (int)(nch / nt);
    const long long fold_threads = WINDOWS * nch;
    msm_fold_kernel<<<(unsigned)((fold_threads + 127) / 128), 128, 0, s>>>(
        ds, perm, points, tails, flags, loc, carry_from, m, (int)ch, (int)nch);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    msm_carry_kernel<<<WINDOWS, nt, 0, s>>>(tails, flags, (int)nch, per);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    msm_bucket_kernel<<<WINDOWS * BUCKETS / 128, 128, 0, s>>>(loc, carry_from, tails, out,
                                                             (int)nch);
    return (int)cudaGetLastError();
}
