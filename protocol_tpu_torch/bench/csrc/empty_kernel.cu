// A yardstick, off the main path: an empty kernel, one block of one thread.  Its device
// time through protocol_tpu_torch/bench/_timing.py::time_ms is the floor of one launch on
// the card, which the byte bounds of the small kernels (the block-total scan, the pointer
// tail) stand beside.
//
// C interface (loaded with ctypes by protocol_tpu_torch/ops/_build.py for
// protocol_tpu_torch/bench/yardsticks.py):
//     int empty_kernel(stream)
// launches on `stream` and returns cudaGetLastError() (0 on success).

#include <cuda_runtime.h>

namespace {

__global__ void empty() {}

}  // namespace

extern "C" int empty_kernel(void* stream) {
  empty<<<1, 1, 0, static_cast<cudaStream_t>(stream)>>>();
  return static_cast<int>(cudaGetLastError());
}
