// The permutation-argument terms of the quotient for Hopper (sm_90a): per
// LDE point x and challenge,
//
//   acc = L_0(x) * (Z(x) - 1) * alpha^0
//       + sum_j alpha^(j+1) * (next_j * g_j - prev_j * f_j)
//
// with f_j, g_j the products over chunk j (7 routed wires) of
//   f_i = w_i + (beta * k_i) * x + gamma,   g_i = w_i + beta * sigma_i + gamma,
// prev_0 = Z, prev_j = pp_(j-1), next_j = pp_j, next_last = Z(x * omega).
//
// Replaces the JAX package's Pallas kernel
//   ops/perm_quotient_pallas.py::perm_quotient_pallas_batched (_stage_batched)
//     -> perm_quotient
//
// Design: one thread per (proof, challenge, point), the running f, g, prev
// and acc in registers; the wire and sigma rows are walked once, each load
// coalesced across the warp.  Z(x * omega) is Z[(t + blowup) mod L], read in
// place (the TPU kernel gets a rolled copy because a roll crosses its tiles).
// The small tables of a (proof, challenge) - the alpha powers alpha^0..alpha^nch
// by the plain version's left fold and the beta * k_i - are made by each block
// for itself in shared memory before its threads start (nch + 1 dependent
// multiplies by one thread, R independent ones spread over the block); made by
// PyTorch operations beforehand they would cost some five hundred small
// launches.  The block of point 0 also writes alpha^(nch+1), the power the
// gate terms go on from.  The wire matrix may carry more rows than are
// routed: the row stride is an argument and the first R rows are read.
//
// What bounds it on this card: per point and challenge about 4 R + 3 nch
// field multiplies (about 360 at R = 80) against (2 R + nch + 3) * 8 bytes
// when both challenges share the wire and sigma rows from cache: as computed
// the integer pipe is the limit at R = 80; the cheapest count is in PERF.md.
//
// The arithmetic mirrors the plain PyTorch version
// (ops/perm_quotient_cuda.py::perm_quotient_plain) formula by formula.
#include <cuda_runtime.h>

#include "goldilocks.cuh"

#define THREADS 128
#define CHUNK 7

// wires: element (k, i, t) at wires[k * wires_k_stride + i * wires_row_stride + t];
// zs [K, C, L], pps [K, C, nch - 1, L], out [K, C, L] contiguous;
// sigma [R, L], xs [L], l0 [L], k_is [R] contiguous;
// betas, gammas, alphas, apows_out [K, C] contiguous.
// Dynamic shared memory: (nch + 1 + R) u64.
__global__ void __launch_bounds__(THREADS)
perm_quotient_kernel(const u64* __restrict__ wires, long long wires_k_stride,
                     long long wires_row_stride, const u64* __restrict__ zs,
                     const u64* __restrict__ pps, const u64* __restrict__ sigma,
                     const u64* __restrict__ xs, const u64* __restrict__ l0,
                     const u64* __restrict__ betas, const u64* __restrict__ gammas,
                     const u64* __restrict__ alphas, const u64* __restrict__ k_is,
                     u64* __restrict__ out, u64* __restrict__ apows_out,
                     int R, int nch, long long L, long long blowup) {
    extern __shared__ u64 shared[];
    u64* apow = shared;              // alpha^0 .. alpha^nch
    u64* beta_k = shared + nch + 1;  // beta * k_i
    long long c = blockIdx.y, C = gridDim.y, k = blockIdx.z;
    long long kc = k * C + c;
    const u64 beta = betas[kc], gamma = gammas[kc];
    for (int i = threadIdx.x; i < R; i += blockDim.x) beta_k[i] = gl_mul(beta, k_is[i]);
    if (threadIdx.x == 0) {
        const u64 alpha = alphas[kc];
        u64 p = 1;
        for (int j = 0; j <= nch; ++j) {
            apow[j] = p;
            p = gl_mul(p, alpha);
        }
        if (blockIdx.x == 0) apows_out[kc] = p;
    }
    __syncthreads();

    long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    if (t >= L) return;
    const u64* w = wires + k * wires_k_stride + t;
    const u64* Z = zs + kc * L;
    const u64* pp = pps + kc * (nch - 1) * L + t;

    u64 x = xs[t];
    u64 z = Z[t];
    u64 acc = gl_add(0, gl_mul(apow[0], gl_mul(l0[t], gl_sub(z, 1))));
    u64 prev = z;
    for (int j = 0; j < nch; ++j) {
        int lo = j * CHUNK, hi = min(lo + CHUNK, R);
        u64 f = 0, g = 0;
        for (int i = lo; i < hi; ++i) {
            u64 v = w[i * wires_row_stride];
            u64 fi = gl_add(gl_add(v, gl_mul(beta_k[i], x)), gamma);
            u64 gi = gl_add(gl_add(v, gl_mul(beta, sigma[i * L + t])), gamma);
            f = i == lo ? fi : gl_mul(f, fi);
            g = i == lo ? gi : gl_mul(g, gi);
        }
        u64 nxt = j == nch - 1 ? Z[(t + blowup) % L] : pp[j * L];
        u64 term = gl_sub(gl_mul(nxt, g), gl_mul(prev, f));
        acc = gl_add(acc, gl_mul(apow[j + 1], term));
        prev = nxt;  // unused after the last chunk
    }
    out[kc * L + t] = acc;
}

extern "C" int perm_quotient(const void* wires, long long wires_k_stride,
                             long long wires_row_stride, const void* zs, const void* pps,
                             const void* sigma, const void* xs, const void* l0,
                             const void* betas, const void* gammas, const void* alphas,
                             const void* k_is, void* out, void* apows_out, int K, int C, int R,
                             int nch, long long L, long long blowup, void* stream) {
    dim3 grid((unsigned int)((L + THREADS - 1) / THREADS), (unsigned int)C, (unsigned int)K);
    size_t shared_bytes = sizeof(u64) * (size_t)(nch + 1 + R);
    perm_quotient_kernel<<<grid, THREADS, shared_bytes, (cudaStream_t)stream>>>(
        (const u64*)wires, wires_k_stride, wires_row_stride, (const u64*)zs, (const u64*)pps,
        (const u64*)sigma, (const u64*)xs, (const u64*)l0, (const u64*)betas,
        (const u64*)gammas, (const u64*)alphas, (const u64*)k_is, (u64*)out, (u64*)apows_out,
        R, nch, L, blowup);
    return (int)cudaGetLastError();
}
