// 2-D float32 transpose, on Hopper.
//
// Replaces the anonymous Pallas kernel of bench/probe_mosaic_gather.py
// (lines 103-117, pallas_call at line 107), which probed Mosaic's in-kernel
// transpose.  For a row-major (R, L) input it writes the row-major (L, R)
//
//     out[c, r] = t[r, c]
//
// What bounds it.  Each element is read once and written once: 8 B per
// element, 8.4 MB at the probe's 1,048,576-element shapes (128 x 8192 and
// 8192 x 128), 2.5 us at 3.35 TB/s.  There is no arithmetic: bound by bytes,
// and at the probe's size close to the launch's own latency.
//
// How the design meets it.  A 32 x 32 tile per block, 32 x 8 threads, each
// thread moving four elements.  The block reads the tile row by row (each
// warp reads 32 consecutive floats of one input row, 128 B coalesced), keeps
// it in shared memory, and writes it column by column (each warp writes 32
// consecutive floats of one output row).  The tile is padded to 33 columns so
// that reading a column of it hits 32 different banks.  Bounds checks on both
// edges let any (R, L) through; grid.x walks the L / 32 column tiles and
// grid.y the R / 32 row tiles (at most 65,535, checked by the wrapper).
//
// Numerics: a pure copy, bit-equal to the plain PyTorch version.
//
// C interface (loaded with ctypes by protocol_tpu_torch/ops/_build.py):
//     int transpose2d(t, out, rows, cols, stream)
// launches on `stream` and returns cudaGetLastError() (0 on success).

#include <cuda_runtime.h>

namespace {

constexpr int kTile = 32;
constexpr int kRowsPerPass = 8;  // threads per block: kTile x kRowsPerPass

__global__ void __launch_bounds__(kTile * kRowsPerPass)
transpose2d_kernel(const float* __restrict__ t, float* __restrict__ out, long long rows,
                   long long cols) {
  __shared__ float tile[kTile][kTile + 1];
  const long long c0 = static_cast<long long>(blockIdx.x) * kTile;
  const long long r0 = static_cast<long long>(blockIdx.y) * kTile;

  const long long c_in = c0 + threadIdx.x;
#pragma unroll
  for (int j0 = 0; j0 < kTile; j0 += kRowsPerPass) {
    const int j = j0 + threadIdx.y;
    const long long r = r0 + j;
    if (r < rows && c_in < cols) tile[j][threadIdx.x] = __ldg(t + r * cols + c_in);
  }
  __syncthreads();

  // Output row c (an input column), output column r (an input row).
  const long long r_out = r0 + threadIdx.x;
#pragma unroll
  for (int j0 = 0; j0 < kTile; j0 += kRowsPerPass) {
    const int j = j0 + threadIdx.y;
    const long long c = c0 + j;
    if (c < cols && r_out < rows) out[c * rows + r_out] = tile[threadIdx.x][j];
  }
}

}  // namespace

extern "C" int transpose2d(const void* t, void* out, long long rows, long long cols,
                           void* stream) {
  if (rows <= 0 || cols <= 0) return 0;
  const dim3 grid(static_cast<unsigned int>((cols + kTile - 1) / kTile),
                  static_cast<unsigned int>((rows + kTile - 1) / kTile));
  const dim3 block(kTile, kRowsPerPass);
  transpose2d_kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(t), static_cast<float*>(out), rows, cols);
  return static_cast<int>(cudaGetLastError());
}
