// The permutation-argument columns, stage 1, for Hopper (sm_90a): per row
// point and challenge, with f_i = w_i + beta * id_i + gamma and
// g_i = w_i + beta * sigma_i + gamma over the R routed wires in chunks of 7,
//
//   f_pref[j]     = product of the f-chunks 0..j
//   g_pref_inv[j] = 1 / (product of the g-chunks 0..j),  j < nch - 1
//   row_quot      = f_pref[nch-1] / (product of all g-chunks)
//
// Replaces the JAX package's Pallas kernel
//   ops/perm_columns_pallas.py::perm_columns_pallas_batched (_stage1_batched)
//     -> perm_columns_stage1
// The running product of row_quot along the rows, Z, the partial products and
// the wrap-around value are that package's XLA tail (_finish) and stay plain
// PyTorch in the port (ops/perm_columns_cuda.py::_finish).
//
// Design: one thread per (proof, challenge, row point).  Only ONE Fermat
// inverse is taken per thread: 1 / G_pref[j] = G_suff[j+1] / G_total, so the
// thread walks the g-chunks from the last to the first, parks each suffix
// product in the slot of the output it will end in, inverts the total, and
// then scales its own parked values in place.  No per-thread array is needed,
// so the number of chunks has no compile-time maximum.  The f-chunks are
// walked forwards in a second pass over the wires, which the cache serves.
// A last chunk of fewer than 7 wires is filled up with factors of 1, exactly
// as the plain version pads it, so the two agree on every input.
//
// What bounds it on this card: per point and challenge about 4 R field
// multiplies for the factors and chunks plus 74 for the inverse (about 400 at
// R = 80) against 3 R * 8 bytes read once for both challenges and
// (2 nch) * 8 bytes written per challenge: the integer pipe is the limit as
// computed; PERF.md has the reckoning.
//
// The arithmetic mirrors the plain PyTorch version
// (ops/perm_columns_cuda.py::stage1_plain) formula by formula.
#include <cuda_runtime.h>

#include "goldilocks.cuh"

#define THREADS 128
#define CHUNK 7

// wires: element (k, i, t) at wires[k * wires_k_stride + i * wires_row_stride + t];
// id_vals, sigma [R, n] contiguous; betas, gammas [K, C];
// f_pref [K, C, nch, n], g_pref_inv [K, C, nch - 1, n], row_quot [K, C, n].
__global__ void __launch_bounds__(THREADS)
perm_columns_stage1_kernel(const u64* __restrict__ wires, long long wires_k_stride,
                           long long wires_row_stride, const u64* __restrict__ id_vals,
                           const u64* __restrict__ sigma, const u64* __restrict__ betas,
                           const u64* __restrict__ gammas, u64* __restrict__ f_pref,
                           u64* __restrict__ g_pref_inv, u64* __restrict__ row_quot,
                           int R, int nch, long long n) {
    long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    if (t >= n) return;
    long long c = blockIdx.y, C = gridDim.y, k = blockIdx.z;
    long long kc = k * C + c;
    const u64 beta = betas[kc], gamma = gammas[kc];
    const u64* w = wires + k * wires_k_stride + t;
    u64* fp = f_pref + kc * nch * n + t;
    u64* gpi = g_pref_inv + kc * (nch - 1) * n + t;

    // g-chunks, last to first: suffix product j+1 parked in g_pref_inv[j]
    u64 g_suff = 0;
    for (int j = nch - 1; j >= 0; --j) {
        u64 g = 0;
        for (int i = j * CHUNK; i < (j + 1) * CHUNK; ++i) {
            u64 gi = 1;
            if (i < R) gi = gl_add(gl_add(w[i * wires_row_stride], gl_mul(beta, sigma[i * n + t])), gamma);
            g = i == j * CHUNK ? gi : gl_mul(g, gi);
        }
        g_suff = j == nch - 1 ? g : gl_mul(g_suff, g);
        if (j > 0) gpi[(j - 1) * n] = g_suff;
    }
    u64 g_total_inv = gl_inv(g_suff);

    // f-chunks, first to last: prefix products
    u64 f_run = 0;
    for (int j = 0; j < nch; ++j) {
        u64 f = 0;
        for (int i = j * CHUNK; i < (j + 1) * CHUNK; ++i) {
            u64 fi = 1;
            if (i < R) fi = gl_add(gl_add(w[i * wires_row_stride], gl_mul(beta, id_vals[i * n + t])), gamma);
            f = i == j * CHUNK ? fi : gl_mul(f, fi);
        }
        f_run = j == 0 ? f : gl_mul(f_run, f);
        fp[j * n] = f_run;
    }
    row_quot[kc * n + t] = gl_mul(f_run, g_total_inv);
    for (int j = 0; j < nch - 1; ++j) gpi[j * n] = gl_mul(gpi[j * n], g_total_inv);
}

extern "C" int perm_columns_stage1(const void* wires, long long wires_k_stride,
                                   long long wires_row_stride, const void* id_vals,
                                   const void* sigma, const void* betas, const void* gammas,
                                   void* f_pref, void* g_pref_inv, void* row_quot, int K, int C,
                                   int R, int nch, long long n, void* stream) {
    dim3 grid((unsigned int)((n + THREADS - 1) / THREADS), (unsigned int)C, (unsigned int)K);
    perm_columns_stage1_kernel<<<grid, THREADS, 0, (cudaStream_t)stream>>>(
        (const u64*)wires, wires_k_stride, wires_row_stride, (const u64*)id_vals,
        (const u64*)sigma, (const u64*)betas, (const u64*)gammas, (u64*)f_pref,
        (u64*)g_pref_inv, (u64*)row_quot, R, nch, n);
    return (int)cudaGetLastError();
}
