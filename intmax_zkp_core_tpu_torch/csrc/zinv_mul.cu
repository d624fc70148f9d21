// The quotient's divide for Hopper (sm_90a): out = acc * Z_H(x)^-1, 0 -> 0.
//
// Replaces the JAX package's Pallas kernel
//   ops/zinv_mul_pallas.py::zinv_mul_pallas (_zinv_mul_impl) -> zinv_mul
//
// Design: a thread takes POINTS points of the evaluation domain, THREADS
// apart, so that a warp reads and writes whole contiguous segments.  The
// block inverts the z_h values of all its points together
// (goldilocks.cuh::batch_inv_loose: each thread's running product, one
// Fermat chain for the block's product, three multiplies for each further
// point; a zero z_h gives 0 in that lane only) and each thread multiplies
// each inverse into that point of every leading row, so the inverse is
// shared by all rows as in the TPU kernel.  Points beyond L enter the batch
// as 1.  The acc values are asked into the L2 cache before the chain, so that
// their reads overlap it.  All arithmetic is loose; each output lane is made
// canonical once, at the store.
//
// What bounds it on this card: per point it moves 8 * (1 + 2 * rows) bytes
// against 3 + rows field multiplies and a share of the block's scans and its
// chain.  One Fermat chain per point (an earlier form of this kernel) made it
// issue-bound at some 13x its byte time.  Now the chain's latency, which the block waits
// for, and the memory phases before and after it are what is left: a copy
// of the same bytes takes two thirds of its time (PERF.md).  (On the
// prover's coset Z_H takes only `blowup` distinct values; this kernel
// computes what the TPU kernel computes, for any z_h.)
//
// The values equal the plain PyTorch version's
// (ops/zinv_mul_cuda.py::zinv_mul_plain) bit for bit: every step is exact mod
// p (tests/test_torch_perm_quotient.py replays this schedule in Python ints).
#include <cuda_runtime.h>

#include "goldilocks.cuh"

#define THREADS 128
#define POINTS 4  // points a thread

__device__ __forceinline__ void prefetch_l2(const u64* p) {
    asm volatile("prefetch.global.L2 [%0];" : : "l"(p));
}

// acc [rows, L] contiguous, z_h [L] -> out [rows, L] contiguous.
__global__ void __launch_bounds__(THREADS)
zinv_mul_kernel(const u64* __restrict__ acc, const u64* __restrict__ z_h,
                u64* __restrict__ out, long long rows, long long L) {
    const long long t0 = (long long)blockIdx.x * (THREADS * POINTS) + threadIdx.x;
    u64 inv[POINTS];
#pragma unroll
    for (int i = 0; i < POINTS; ++i) {
        const long long t = t0 + i * THREADS;
        inv[i] = t < L ? z_h[t] : 1;
    }
    // the thread's acc values are fetched into the L2 cache while the chain runs
    for (long long r = 0; r < rows; ++r) {
#pragma unroll
        for (int i = 0; i < POINTS; ++i) {
            const long long t = t0 + i * THREADS;
            if (t < L) prefetch_l2(acc + r * L + t);
        }
    }
    batch_inv_loose<THREADS>(inv);
    for (long long r = 0; r < rows; ++r) {
#pragma unroll
        for (int i = 0; i < POINTS; ++i) {
            const long long t = t0 + i * THREADS;
            if (t < L) out[r * L + t] = gl_canon(gl_mul_loose(acc[r * L + t], inv[i]));
        }
    }
}

extern "C" {

// The batch layout: THREADS threads a block, POINTS points a thread, which
// lie THREADS apart (chip_smoke.py plants zeros in one thread's points by
// it).
int zinv_mul_threads(void) { return THREADS; }
int zinv_mul_points(void) { return POINTS; }

int zinv_mul(const void* acc, const void* z_h, void* out, long long rows, long long L,
             void* stream) {
    const unsigned int blocks = (unsigned int)((L + THREADS * POINTS - 1) / (THREADS * POINTS));
    zinv_mul_kernel<<<blocks, THREADS, 0, (cudaStream_t)stream>>>(
        (const u64*)acc, (const u64*)z_h, (u64*)out, rows, L);
    return (int)cudaGetLastError();
}

}  // extern "C"
