// K10: BN254 Fr / Fq Montgomery multiply (and add, subtract) of word vectors, on Hopper.
//
// Replaces `protocol_tpu/zk/graft/field.py:266,271` `mulmod_fr` / `mulmod_fq` (their helpers
// `mul_full` :160, `_mul_cols` :138, `_carry_sweep` :96, `_gp_prefix` :78 and `Field.redc`
// :215), and with a broadcast operand `protocol_tpu/zk/graft/ntt.py:100` `_scale_fn` and
// `Field.to_mont` / `from_mont`.  The reference builds each 512-bit product as a one-hot
// f32 matmul over sixteen 16-bit limbs and resolves its carries with a Kogge-Stone
// prefix; here one thread holds an element as eight 32-bit limbs in registers and runs
// the CIOS loop of `bn254_field.cuh` with 64-bit products and carries.  The plain
// version is `protocol_tpu_torch/zk/graft/field.py::_plain`.
//
// out[i] = a[i] (op) b[i or 0], op 0 the Montgomery product a * b * 2^-256 mod p, 1 the
// sum, 2 the difference, all canonical; `b_full` 0 broadcasts b's one element.  Field 0
// is Fr, 1 Fq.  Operands are (n, 4) uint64 words (the port passes int64 tensors of the
// same bits), 16-byte aligned; one thread an element, a grid-stride loop.
//
// What bounds it.  A multiply is 128 32x32 -> 64-bit products, each an IMAD.WIDE (two
// 32-bit multiply-adds of the SM's integer pipe), and 8 low-word products for the m, one
// IMAD each: 264 IMADs an element; against that it
// moves 96 bytes (64 with b broadcast).  At Hopper's 64 integer lanes an SM a clock, an
// element's IMADs cost about as long as its bytes at 3.35 TB/s: the kernel is near the
// line between the two, and `chip_smoke.py` states both bounds.  The design keeps every
// limb in registers and reads and writes each element once, two 16-byte loads a row.
#include <cstdint>

#include <cuda_runtime.h>

#include "bn254_field.cuh"

namespace {

template <int F, int OP>
__global__ void __launch_bounds__(256) mulmod_kernel(const uint64_t* __restrict__ a,
                                                     const uint64_t* __restrict__ b,
                                                     uint64_t* __restrict__ out, long long n,
                                                     int b_full) {
    const long long stride = (long long)gridDim.x * blockDim.x;
    for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n; i += stride) {
        bn254::Fe x = bn254::load(a + 4 * i);
        bn254::Fe y = bn254::load(b + (b_full ? 4 * i : 0));
        bn254::Fe r;
        if (OP == 0) {
            r = bn254::mont_mul<F>(x, y);
        } else if (OP == 1) {
            r = bn254::add<F>(x, y);
        } else {
            r = bn254::sub<F>(x, y);
        }
        bn254::store(out + 4 * i, r);
    }
}

template <int F>
void launch(int op, const uint64_t* a, const uint64_t* b, uint64_t* out, long long n, int b_full,
            int grid, cudaStream_t s) {
    if (op == 0) {
        mulmod_kernel<F, 0><<<grid, 256, 0, s>>>(a, b, out, n, b_full);
    } else if (op == 1) {
        mulmod_kernel<F, 1><<<grid, 256, 0, s>>>(a, b, out, n, b_full);
    } else {
        mulmod_kernel<F, 2><<<grid, 256, 0, s>>>(a, b, out, n, b_full);
    }
}

}  // namespace

extern "C" int zk_mulmod(const uint64_t* a, const uint64_t* b, uint64_t* out, long long n,
                         long long b_full, int field, int op, void* stream) {
    if (n <= 0) return 0;
    if (field < 0 || field > 1 || op < 0 || op > 2) return (int)cudaErrorInvalidValue;
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    long long blocks = (n + 255) / 256;
    int grid = (int)(blocks < 132 * 16 ? blocks : 132 * 16);
    if (field == 0) {
        launch<bn254::FR>(op, a, b, out, n, (int)b_full, grid, s);
    } else {
        launch<bn254::FQ>(op, a, b, out, n, (int)b_full, grid, s);
    }
    return (int)cudaGetLastError();
}
