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
// Design: one thread per (proof, point) and CG challenges (all of them for
// C <= 4; a template on CG, and for any other C one challenge per thread
// with the challenges along the grid), so each wire and sigma value is
// loaded once for every challenge of the group, where a thread per challenge
// would take the 80 wire and 80 sigma rows from device memory once per
// challenge (they do not fit in the L2 cache at the main path's 2^18
// points).  A chunk's 7 wire and 7 sigma values and its next_j are loaded
// before its products: the next chunk's are loaded while this one's are
// multiplied.  The factors and chunk products are loose (goldilocks.cuh: any
// u64 stands for its residue), each factor one fused multiply-add with
// w_i + gamma shared by f_i and g_i, and each challenge's
// alpha fold sum_j alpha^j * term_j is ONE GlDot (a 160-bit sum of 64x64
// products: 1 + nch terms, no reduction per term), reduced once and made
// canonical at the write.  Z(x * omega) is Z[(t + blowup) mod L], read in
// place (the TPU kernel gets a rolled copy because a roll crosses its tiles).
// The small tables of each challenge - the alpha powers alpha^0..alpha^nch
// by the plain version's left fold and the beta * k_i - are made by each
// block for itself in shared memory before its threads start (nch + 1
// dependent multiplies by one thread per challenge, CG R independent ones
// spread over the block; blocks of 256 threads, which ran faster than 128 or
// 64: PERF.md).  The block of point 0 also writes alpha^(nch+1),
// the power the gate terms go on from.  The wire matrix may carry more rows
// than are routed: the row stride is an argument and the first R rows are
// read.
//
// What bounds it on this card: per row point, (K R + R + 2) * 8 bytes of
// wires, sigma, xs and l0 read and K C (nch + 1) * 8 of Z, the partial
// products and acc moved, against about 330 field multiplies per point,
// proof and challenge: bytes, at R = 80 (chip_smoke.py::perm_quotient_bound).
//
// The values equal the plain PyTorch version's
// (ops/perm_quotient_cuda.py::perm_quotient_plain): every operation is exact
// mod p, so the one reduction per sum and the loose intermediates change no
// value (tests/test_torch_perm_quotient.py replays this order in Python
// ints).
#include <cuda_runtime.h>

#include "perm_chunk.cuh"

#define THREADS 256

// The thread's values of chunk j: wire and sigma rows 7 j .. 7 j + m - 1
// (m <= CHUNK) and next_j of each challenge of the group (pp_j, or
// Z(x * omega) for the last chunk).
template <int CG>
__device__ __forceinline__ void load_chunk(u64 (&wv)[CHUNK], u64 (&sv)[CHUNK], u64 (&nxt)[CG],
                                           const u64* w, long long w_stride, const u64* sigma,
                                           const u64* zs, const u64* pps, long long kc0,
                                           long long t, long long t_next, long long L, int nch,
                                           int R, int j) {
    const int lo = j * CHUNK, m = min(CHUNK, R - lo);
#pragma unroll
    for (int i = 0; i < CHUNK; ++i) {
        if (i < m) {
            wv[i] = w[(long long)(lo + i) * w_stride];
            sv[i] = sigma[(long long)(lo + i) * L];
        }
    }
#pragma unroll
    for (int c = 0; c < CG; ++c)
        nxt[c] = j == nch - 1 ? zs[(kc0 + c) * L + t_next] : pps[((kc0 + c) * (nch - 1) + j) * L + t];
}

// wires: element (k, i, t) at wires[k * wires_k_stride + i * wires_row_stride + t];
// zs [K, C, L], pps [K, C, nch - 1, L], out [K, C, L] contiguous;
// sigma [R, L], xs [L], l0 [L], k_is [R] contiguous;
// betas, gammas, alphas, apows_out [K, C] contiguous.  Challenges
// blockIdx.y * CG .. + CG - 1.
// Dynamic shared memory: CG * (nch + 1 + R) u64, per challenge alpha^0 ..
// alpha^nch, then beta * k_0 .. beta * k_(R-1).
template <int CG>
__global__ void __launch_bounds__(THREADS)
perm_quotient_kernel(const u64* __restrict__ wires, long long wires_k_stride,
                     long long wires_row_stride, const u64* __restrict__ zs,
                     const u64* __restrict__ pps, const u64* __restrict__ sigma,
                     const u64* __restrict__ xs, const u64* __restrict__ l0,
                     const u64* __restrict__ betas, const u64* __restrict__ gammas,
                     const u64* __restrict__ alphas, const u64* __restrict__ k_is,
                     u64* __restrict__ out, u64* __restrict__ apows_out, int C, int R, int nch,
                     long long L, long long blowup) {
    extern __shared__ u64 shared[];
    const int tab_c = nch + 1 + R;  // one challenge's tables
    const long long kc0 = (long long)blockIdx.z * C + (long long)blockIdx.y * CG;
    for (int e = threadIdx.x; e < CG * R; e += THREADS) {
        const int c = e / R, i = e % R;
        shared[c * tab_c + nch + 1 + i] = gl_mul(betas[kc0 + c], k_is[i]);
    }
    if (threadIdx.x < CG) {
        const int c = threadIdx.x;
        const u64 alpha = alphas[kc0 + c];
        u64 p = 1;
        for (int j = 0; j <= nch; ++j) {
            shared[c * tab_c + j] = p;
            p = gl_mul(p, alpha);
        }
        if (blockIdx.x == 0) apows_out[kc0 + c] = p;
    }
    __syncthreads();

    const long long t = (long long)blockIdx.x * THREADS + threadIdx.x;
    if (t >= L) return;
    const u64* w = wires + (long long)blockIdx.z * wires_k_stride + t;
    const long long t_next = (t + blowup) % L;
    const u64 x = xs[t], l = l0[t];
    u64 beta[CG], gamma[CG], prev[CG];
    GlDot dot[CG];
#pragma unroll
    for (int c = 0; c < CG; ++c) {
        beta[c] = betas[kc0 + c];
        gamma[c] = gammas[kc0 + c];
        prev[c] = zs[(kc0 + c) * L + t];
        dot[c].mac(l, gl_sub_loose(prev[c], 1));  // alpha^0 = 1
    }
    // the next chunk's wire, sigma and next_j values are loaded before this
    // chunk's products
    u64 wv[CHUNK], sv[CHUNK], nxt[CG];
    load_chunk<CG>(wv, sv, nxt, w, wires_row_stride, sigma + t, zs, pps, kc0, t, t_next, L, nch, R, 0);
#pragma unroll 1
    for (int j = 0; j < nch; ++j) {
        const int lo = j * CHUNK, m = min(CHUNK, R - lo);
        u64 wn[CHUNK], sn[CHUNK], nxn[CG];
        if (j + 1 < nch)
            load_chunk<CG>(wn, sn, nxn, w, wires_row_stride, sigma + t, zs, pps, kc0, t, t_next, L,
                           nch, R, j + 1);
#pragma unroll
        for (int c = 0; c < CG; ++c) {
            const u64* bk = shared + c * tab_c + nch + 1 + lo;
            u64 wg[CHUNK];  // w_i + gamma, shared by f_i and g_i
#pragma unroll
            for (int i = 0; i < CHUNK; ++i)
                if (i < m) wg[i] = gl_add_loose(wv[i], gamma[c]);
            const u64 f = chunk_product(m, [&](int i) { return gl_mul_add_loose(bk[i], x, wg[i]); });
            const u64 g = chunk_product(m, [&](int i) { return gl_mul_add_loose(beta[c], sv[i], wg[i]); });
            const u64 term = gl_sub_loose(gl_mul_loose(nxt[c], g), gl_canon(gl_mul_loose(prev[c], f)));
            dot[c].mac(shared[c * tab_c + j + 1], term);
            prev[c] = nxt[c];  // unused after the last chunk
        }
#pragma unroll
        for (int i = 0; i < CHUNK; ++i) {
            wv[i] = wn[i];
            sv[i] = sn[i];
        }
#pragma unroll
        for (int c = 0; c < CG; ++c) nxt[c] = nxn[c];
    }
#pragma unroll
    for (int c = 0; c < CG; ++c) out[(kc0 + c) * L + t] = gl_canon(gl_dot_reduce(dot[c]));
}

template <int CG>
static int launch(const void* wires, long long wires_k_stride, long long wires_row_stride,
                  const void* zs, const void* pps, const void* sigma, const void* xs,
                  const void* l0, const void* betas, const void* gammas, const void* alphas,
                  const void* k_is, void* out, void* apows_out, int K, int C, int R, int nch,
                  long long L, long long blowup, cudaStream_t stream) {
    dim3 grid((unsigned int)((L + THREADS - 1) / THREADS), (unsigned int)(C / CG), (unsigned int)K);
    const size_t shared_bytes = sizeof(u64) * (size_t)CG * (size_t)(nch + 1 + R);
    if (shared_bytes > 48 * 1024) {  // above 48 KB only with this attribute
        cudaError_t err = cudaFuncSetAttribute(perm_quotient_kernel<CG>,
                                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                                               (int)shared_bytes);
        if (err != cudaSuccess) return (int)err;
    }
    perm_quotient_kernel<CG><<<grid, THREADS, shared_bytes, stream>>>(
        (const u64*)wires, wires_k_stride, wires_row_stride, (const u64*)zs, (const u64*)pps,
        (const u64*)sigma, (const u64*)xs, (const u64*)l0, (const u64*)betas,
        (const u64*)gammas, (const u64*)alphas, (const u64*)k_is, (u64*)out, (u64*)apows_out,
        C, R, nch, L, blowup);
    return (int)cudaGetLastError();
}

extern "C" int perm_quotient(const void* wires, long long wires_k_stride,
                             long long wires_row_stride, const void* zs, const void* pps,
                             const void* sigma, const void* xs, const void* l0,
                             const void* betas, const void* gammas, const void* alphas,
                             const void* k_is, void* out, void* apows_out, int K, int C, int R,
                             int nch, long long L, long long blowup, void* stream) {
    cudaStream_t s = (cudaStream_t)stream;
#define ARGS wires, wires_k_stride, wires_row_stride, zs, pps, sigma, xs, l0, betas, gammas, \
             alphas, k_is, out, apows_out, K, C, R, nch, L, blowup, s
    switch (C) {
        case 1: return launch<1>(ARGS);
        case 2: return launch<2>(ARGS);
        case 3: return launch<3>(ARGS);
        case 4: return launch<4>(ARGS);
        default: return launch<1>(ARGS);  // one challenge per thread, C along the grid
    }
#undef ARGS
}
