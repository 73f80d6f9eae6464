// The first K12, kept as a yardstick: the Pippenger MSM's per-window digit sort,
// one block a window with warp-aggregated shared atomics.  `ops/csrc/zk_msm_window.cu`
// (a stable counting sort over a cluster of blocks a window) replaced it on the path;
// `protocol_tpu_torch/bench/yardsticks.py::msm_window_atomic` launches it beside that.
//
// Replaces `protocol_tpu/zk/graft/pippenger.py:142` `window` (`zk-graft-msm-window`): for
// each of the 32 windows, the argsort of the windows' 8-bit digits and the digits in that
// order.  The reference takes the digits as the scalars' bytes transposed on the host
// (`pippenger.py:376`), argsorts them and gathers the points into a (32, m, 3, 16) batch;
// here the digits are read on the card straight from the (m, 4) uint64 scalars (byte w of
// scalar i is window w's digit), and only the order `perm` and the sorted digits `ds`
// are written, (32, m) int32 each: K13 reads points[perm] itself, so the gathered batch
// (50 MB at m = 16,384) never reaches device memory.  The plain version is
// `protocol_tpu_torch/zk/graft/pippenger.py::_window_plain` (a stable `torch.sort`).
//
// One block a window runs a counting sort: a 256-bin histogram in shared memory, its
// exclusive prefix, then each lane's slot from an atomic on its digit's cursor.  The order
// inside one digit is the atomics' and not stable; a digit's group sum does not depend on
// it, and `perm` is a permutation with digits[perm] == ds.
//
// What bounds it.  Skew: PLONK's witness and selector columns are mostly 0 and 1, so one
// bin can take almost every lane of a window, and atomics on one shared-memory word
// serialise.  Each warp first groups its lanes by digit (`__match_any_sync`) and one lane
// a group adds the group's count, so a warp makes at most one atomic a distinct digit.
// The bytes are small (the scalars, 32 B a lane, read once per window from L2, and 8 B a
// lane and window written: 4.7 MB at m = 16,384); 32 blocks use 32 SMs.
#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int WINDOWS = 32;
constexpr int BINS = 256;
constexpr int THREADS = 1024;

__global__ void __launch_bounds__(THREADS)
msm_window_atomic_kernel(const uint8_t* __restrict__ bytes, int* __restrict__ ds,
                         int* __restrict__ perm, long long m) {
    __shared__ int hist[BINS];
    __shared__ int cursor[BINS];
    const int w = blockIdx.x;
    const unsigned lane = threadIdx.x & 31u;
    for (int i = threadIdx.x; i < BINS; i += blockDim.x) hist[i] = 0;
    __syncthreads();
    // Every thread runs every round, so the warp-wide intrinsics see all 32 lanes; a lane
    // past m takes a digit of its own (-1 - lane) that matches nothing and counts nothing.
    for (long long base = 0; base < m; base += blockDim.x) {
        long long i = base + threadIdx.x;
        bool valid = i < m;
        int d = valid ? (int)bytes[i * 32 + w] : -1 - (int)lane;
        unsigned peers = __match_any_sync(0xffffffffu, d);
        if (valid && lane == (unsigned)(__ffs(peers) - 1)) atomicAdd(&hist[d], __popc(peers));
    }
    __syncthreads();
    if (threadIdx.x == 0) {
        int s = 0;
        for (int d = 0; d < BINS; ++d) {
            cursor[d] = s;
            s += hist[d];
        }
    }
    __syncthreads();
    int* ds_w = ds + (long long)w * m;
    int* perm_w = perm + (long long)w * m;
    for (long long base = 0; base < m; base += blockDim.x) {
        long long i = base + threadIdx.x;
        bool valid = i < m;
        int d = valid ? (int)bytes[i * 32 + w] : -1 - (int)lane;
        unsigned peers = __match_any_sync(0xffffffffu, d);
        int leader = __ffs(peers) - 1;
        int slot = 0;
        if (valid && lane == (unsigned)leader) slot = atomicAdd(&cursor[d], __popc(peers));
        slot = __shfl_sync(0xffffffffu, slot, leader);
        slot += __popc(peers & ((1u << lane) - 1u));
        if (valid) {
            ds_w[slot] = d;
            perm_w[slot] = (int)i;
        }
    }
}

}  // namespace

extern "C" int zk_msm_window_atomic(const uint64_t* scalars, int* ds, int* perm, long long m,
                                    void* stream) {
    if (m <= 0) return 0;
    msm_window_atomic_kernel<<<WINDOWS, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
        reinterpret_cast<const uint8_t*>(scalars), ds, perm, m);
    return (int)cudaGetLastError();
}
