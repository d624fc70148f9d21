// The quotient's divide for Hopper (sm_90a): out = acc * Z_H(x)^-1.
//
// Replaces the JAX package's Pallas kernel
//   ops/zinv_mul_pallas.py::zinv_mul_pallas (_zinv_mul_impl) -> zinv_mul
//
// Design: one thread per point of the evaluation domain.  It inverts z_h[t]
// once (gl_inv: 64 squarings and 10 multiplies, a dependent chain in two
// registers) and multiplies the inverse into that point of every leading row,
// so the inverse is shared by all rows as in the TPU kernel.  Neighbouring
// threads read and write neighbouring addresses.
//
// What bounds it on this card: per point it moves 8 * (1 + 2 * rows) bytes
// and spends about 74 + rows field multiplies, so as computed it is bound by
// the integer pipe.  (On the prover's coset Z_H takes only `blowup` distinct
// values, so the cheapest formulation inverts those few and is bound by
// bytes; this kernel computes what the TPU kernel computes, for any z_h.)
//
// The arithmetic mirrors the plain PyTorch version
// (ops/zinv_mul_cuda.py::zinv_mul_plain); results are bit-identical.
#include <cuda_runtime.h>

#include "goldilocks.cuh"

#define THREADS 128

// acc [rows, L] contiguous, z_h [L] -> out [rows, L] contiguous.
__global__ void __launch_bounds__(THREADS)
zinv_mul_kernel(const u64* __restrict__ acc, const u64* __restrict__ z_h,
                u64* __restrict__ out, long long rows, long long L) {
    long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    if (t >= L) return;
    u64 z_inv = gl_inv(z_h[t]);
    for (long long r = 0; r < rows; ++r) out[r * L + t] = gl_mul(acc[r * L + t], z_inv);
}

extern "C" int zinv_mul(const void* acc, const void* z_h, void* out, long long rows,
                        long long L, void* stream) {
    unsigned int blocks = (unsigned int)((L + THREADS - 1) / THREADS);
    zinv_mul_kernel<<<blocks, THREADS, 0, (cudaStream_t)stream>>>(
        (const u64*)acc, (const u64*)z_h, (u64*)out, rows, L);
    return (int)cudaGetLastError();
}
