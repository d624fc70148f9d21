// The initial FRI evaluation vector for Hopper (sm_90a):
//
//   G(x) = (comb1(x) - comb1(zeta)) / (x - zeta)
//        + (comb2(x) - comb2(g*zeta)) / (x - g*zeta)
//
// over F_p[X] / (X^2 - 7), for every point x of the LDE coset.
//
// Replaces the JAX package's Pallas kernel
//   ops/fri_init_pallas.py::fri_initial_pallas_batched (_stage) -> fri_initial
//
// Design: one thread per (proof, point).  x lies in the base field, so each
// denominator is (x - z0) - z1*X with z1 a scalar of the proof, and its
// inverse needs one base-field inverse of the norm (x - z0)^2 - 7*z1^2.  The
// eight scalars of a proof (zeta, g*zeta, comb1(zeta), comb2(g*zeta)) are read
// by every thread of the proof (the same address across a warp: one broadcast
// load), and each thread takes 7*z1^2 itself: two multiplies beside some
// eighty, where a table made by PyTorch operations beforehand would cost a
// hundred small launches.  comb1, comb2 and G are interleaved [L, 2], so a
// thread loads and stores 16-byte pairs.
//
// What bounds it on this card: per point it moves 56 bytes and spends two
// Fermat inverses plus some twenty multiplies (about 170 field multiplies):
// the integer pipe, not memory, is the limit.
//
// The arithmetic gives the values of the plain PyTorch version
// (ops/fri_init_cuda.py::fri_initial_plain) bit for bit.
#include <cuda_runtime.h>

#include "goldilocks.cuh"

#define THREADS 128

// one quotient term: (a - az) / (x - z), z = z0 + z1*X
__device__ __forceinline__ void fri_term(u64 x, const u64* __restrict__ z, ulonglong2 a,
                                         const u64* __restrict__ az, u64& g0, u64& g1) {
    u64 z0 = z[0], z1 = z[1], az0 = az[0], az1 = az[1];
    // inverse of d = (x - z0) - z1*X: conj(d) / norm(d), norm(d) = d0^2 - 7 z1^2
    u64 d0 = gl_sub(x, z0);
    u64 n_inv = gl_inv(gl_sub(gl_mul(d0, d0), gl_mul_small(gl_mul(z1, z1), 7)));
    u64 di0 = gl_mul(d0, n_inv);
    u64 di1 = gl_mul(n_inv, z1);  // -(-z1) * n_inv
    u64 n0 = gl_sub(a.x, az0);
    u64 n1 = gl_sub(a.y, az1);
    g0 = gl_add(gl_mul(n0, di0), gl_mul_small(gl_mul(n1, di1), 7));
    g1 = gl_add(gl_mul(n0, di1), gl_mul(n1, di0));
}

// comb1, comb2, out [K, L, 2] contiguous and 16-byte aligned; xs [L];
// zetas, gzetas, c1z, c2gz [K, 2] contiguous.
__global__ void __launch_bounds__(THREADS)
fri_initial_kernel(const ulonglong2* __restrict__ comb1, const ulonglong2* __restrict__ comb2,
                   const u64* __restrict__ xs, const u64* __restrict__ zetas,
                   const u64* __restrict__ gzetas, const u64* __restrict__ c1z,
                   const u64* __restrict__ c2gz, ulonglong2* __restrict__ out, long long L) {
    long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    if (t >= L) return;
    long long k = blockIdx.y;
    u64 x = xs[t];
    u64 t10, t11, t20, t21;
    fri_term(x, zetas + 2 * k, comb1[k * L + t], c1z + 2 * k, t10, t11);
    fri_term(x, gzetas + 2 * k, comb2[k * L + t], c2gz + 2 * k, t20, t21);
    ulonglong2 g;
    g.x = gl_add(t10, t20);
    g.y = gl_add(t11, t21);
    out[k * L + t] = g;
}

extern "C" int fri_initial(const void* comb1, const void* comb2, const void* xs,
                           const void* zetas, const void* gzetas, const void* c1z,
                           const void* c2gz, void* out, long long K, long long L,
                           void* stream) {
    dim3 grid((unsigned int)((L + THREADS - 1) / THREADS), (unsigned int)K);
    fri_initial_kernel<<<grid, THREADS, 0, (cudaStream_t)stream>>>(
        (const ulonglong2*)comb1, (const ulonglong2*)comb2, (const u64*)xs, (const u64*)zetas,
        (const u64*)gzetas, (const u64*)c1z, (const u64*)c2gz, (ulonglong2*)out, L);
    return (int)cudaGetLastError();
}
