// The permutation-argument columns for Hopper (sm_90a): the whole function,
// Z, the partial products and the wrap-around value, in three launches.  Per
// row point t and challenge, with f_i = w_i + beta * id_i + gamma and
// g_i = w_i + beta * sigma_i + gamma over the R routed wires in chunks of 7,
// F_pref[j] / G_pref[j] the products of the f- / g-chunks 0..j:
//
//   q_j[t]      = F_pref[j] / G_pref[j]   (j < nch - 1)
//   row_quot[t] = F_pref[nch-1] / G_pref[nch-1]
//   z[t]        = row_quot[0] * ... * row_quot[t-1]   (z[0] = 1)
//   pp[j][t]    = z[t] * q_j[t],   wrap = row_quot[0] * ... * row_quot[n-1]
//
// Replaces the JAX package's
//   ops/perm_columns_pallas.py::perm_columns_pallas_batched
// which is a Pallas kernel (_stage1_batched, the elementwise stage) and an
// XLA tail (_finish: the running product by jax.lax.associative_scan, Z and
// the partial products).  Both are here: nothing of the function is left to
// PyTorch operations.
//
// Design:
//   A. perm_columns_rows_kernel: one thread per (proof, challenge, row
//      point); the C blocks of one block of points are neighbours in the
//      grid, so the second challenge's wire loads find them in the L2 cache.
//      (C challenges in one thread, which loads each wire value once, ran
//      slower at the main path's shape: 32 K threads on 132 SMs leave the
//      pass latency-bound, and one thread per challenge doubles the warps;
//      PERF.md.)  One walk over the chunks: a chunk's 7 wire, id and sigma
//      values are loaded before its products, each factor is one fused
//      multiply-add (w_i + gamma shared by f_i and g_i), F_pref[j] is parked
//      in the slot of pp[j] and the g-chunk product g_j in the scratch g_mid.
//      Then ONE Fermat inverse of G_total (a zero total gives 0 in that lane
//      only, as the plain version's gl.inv(0) = 0), and a walk back over the
//      parked values turns slot j into q_j = F_pref[j] * G_suff[j+1] /
//      G_total.  The block's exclusive product scan of row_quot (warp
//      shuffles, the warps' totals through shared memory) goes into z, the
//      block's total into `totals`.  A last chunk of fewer than 7 wires
//      multiplies only the wires it has (the plain version's factors of 1).
//   B. perm_columns_carries_kernel: one block per (proof, challenge) scans
//      that pair's block totals in steps of SCAN, carrying the product
//      between steps, so any number of blocks is taken; each total becomes
//      the product of the totals before it, and the last carry is wrap.
//   C. perm_columns_finish_kernel: elementwise, z = carry * z and
//      pp[j] = z * q_j, each written canonical.
// All arithmetic between loads and the last write is loose (goldilocks.cuh:
// any u64 stands for its residue; canonical once, at each output write).
//
// What bounds it on this card: per row point, (K R + 2 R) * 8 bytes of
// wires, id and sigma read and K C nch * 8 of z and pp written, against
// about 350 field multiplies per point, proof and challenge: bytes bound the
// function (chip_smoke.py::perm_columns_bound).  At the main path's shape
// pass A has 64 K threads on 132 SMs, each some 450 multiplies, most of
// them in dependent chains: it is latency-bound, and takes most of the
// function's time.
//
// The values equal the plain PyTorch version's
// (ops/perm_columns_cuda.py::perm_columns_plain): every operation is exact
// mod p, so the association order of the running product and the loose
// intermediates change no value (tests/test_torch_perm_columns.py replays
// this schedule in Python ints).
#include <cuda_runtime.h>

#include "perm_chunk.cuh"

#define ROWS 128   // row points per block of passes A and C
#define SCAN 256   // block totals per step of pass B
#define WARP 32

// Exclusive product scan of one loose value per thread over a block of
// THREADS threads: returns the product of the values of the threads before
// this one (1 for the first) and sets `total` to the product of all.  Every
// thread of the block calls it; `warp_tot` is shared memory of THREADS / 32.
template <int THREADS>
__device__ __forceinline__ u64 block_scan(u64 x, u64* warp_tot, u64& total) {
    const int lane = threadIdx.x % WARP, warp = threadIdx.x / WARP;
#pragma unroll
    for (int d = 1; d < WARP; d *= 2) {
        const u64 y = __shfl_up_sync(0xffffffffu, x, d);
        if (lane >= d) x = gl_mul_loose(x, y);
    }
    const u64 before = __shfl_up_sync(0xffffffffu, x, 1);
    if (lane == WARP - 1) warp_tot[warp] = x;
    __syncthreads();
    u64 pre = 1;
    total = 1;
#pragma unroll
    for (int w = 0; w < THREADS / WARP; ++w) {
        const u64 v = warp_tot[w];
        if (w < warp) pre = gl_mul_loose(pre, v);
        total = gl_mul_loose(total, v);
    }
    __syncthreads();  // warp_tot is written again by the next call
    return lane == 0 ? pre : gl_mul_loose(pre, before);
}

// x^(2^n) * y on loose values; the squarings stay rolled.
__device__ __forceinline__ u64 sqn_mul(u64 x, int n, u64 y) {
#pragma unroll 1
    for (int i = 0; i < n; ++i) x = gl_sqr_loose(x);
    return gl_mul_loose(x, y);
}

// x^(p-2) (0 -> 0) on loose values, by the addition chain of
// goldilocks.cuh::gl_inv.
__device__ __forceinline__ u64 inv_loose(u64 x) {
    const u64 c2 = sqn_mul(x, 1, x), c4 = sqn_mul(c2, 2, c2), c8 = sqn_mul(c4, 4, c4);
    const u64 c30 = sqn_mul(sqn_mul(sqn_mul(sqn_mul(c8, 8, c8), 8, c8), 4, c4), 2, c2);
    const u64 c31 = sqn_mul(c30, 1, x), c32 = sqn_mul(c31, 1, x);  // x^(2^31 - 1), x^(2^32 - 1)
    return sqn_mul(c31, 33, c32);  // p - 2 = (2^31 - 1) * 2^33 + (2^32 - 1)
}

// Pass A.  Grid (nb * C, K): block x is point block x / C of challenge x % C,
// so the C blocks that read the same wire values run next to each other.
// wires: element (k, i, t) at wires[k * wires_k_stride + i * wires_row_stride + t];
// id_vals, sigma [R, n]; betas, gammas [K, C]; z [K, C, n] <- the in-block
// exclusive prefix of row_quot; pp [K, C, nch - 1, n] <- q_j; g_mid
// [K, C, nch - 2, n], scratch: the g-chunk products 1 .. nch - 2; totals
// [K, C, nb] <- the blocks' products (loose).
__global__ void __launch_bounds__(ROWS)
perm_columns_rows_kernel(const u64* __restrict__ wires, long long wires_k_stride,
                         long long wires_row_stride, const u64* __restrict__ id_vals,
                         const u64* __restrict__ sigma, const u64* __restrict__ betas,
                         const u64* __restrict__ gammas, u64* __restrict__ z,
                         u64* __restrict__ pp, u64* __restrict__ g_mid, u64* __restrict__ totals,
                         int C, int R, int nch, long long n) {
    __shared__ u64 warp_tot[ROWS / WARP];
    const long long nb = gridDim.x / C, b = blockIdx.x / C;
    const long long kc = (long long)blockIdx.y * C + blockIdx.x % C;
    const long long t = b * ROWS + threadIdx.x;
    u64 quot = 1;  // beyond the last point: the scan's identity
    if (t < n) {
        const u64 beta = betas[kc], gamma = gammas[kc];
        const u64* w = wires + (long long)blockIdx.y * wires_k_stride + t;
        u64* slot = pp + kc * (nch - 1) * n + t;          // F_pref[j], then q_j, at slot[j * n]
        u64* mid = g_mid + kc * max(nch - 2, 0) * n + t;  // g_j at mid[(j - 1) * n]

        // one walk over the chunks: a chunk's 7 wire, id and sigma values are
        // loaded before its products
        u64 F = 0, G = 0, g = 0;
#pragma unroll 1
        for (int j = 0; j < nch; ++j) {
            const int lo = j * CHUNK, m = min(CHUNK, R - lo);
            u64 wg[CHUNK], iv[CHUNK], sv[CHUNK];  // wg: w_i + gamma, shared by f_i and g_i
#pragma unroll
            for (int i = 0; i < CHUNK; ++i) {
                if (i < m) {
                    wg[i] = w[(long long)(lo + i) * wires_row_stride];
                    iv[i] = id_vals[(long long)(lo + i) * n + t];
                    sv[i] = sigma[(long long)(lo + i) * n + t];
                }
            }
#pragma unroll
            for (int i = 0; i < CHUNK; ++i)
                if (i < m) wg[i] = gl_add_loose(wg[i], gamma);
            const u64 f = chunk_product(m, [&](int i) { return gl_mul_add_loose(beta, iv[i], wg[i]); });
            g = chunk_product(m, [&](int i) { return gl_mul_add_loose(beta, sv[i], wg[i]); });
            F = j == 0 ? f : gl_mul_loose(F, f);
            G = j == 0 ? g : gl_mul_loose(G, g);
            if (j < nch - 1) slot[(long long)j * n] = F;
            if (j > 0 && j < nch - 1) mid[(long long)(j - 1) * n] = g;
        }
        const u64 g_inv = inv_loose(G);  // 1 / G_total
        quot = gl_mul_loose(F, g_inv);

        // back: q_j = F_pref[j] * G_suff[j+1] / G_total, G_suff running from g_(nch-1)
#pragma unroll 4
        for (int j = nch - 2; j >= 0; --j) {
            u64* s = slot + (long long)j * n;
            *s = gl_mul_loose(gl_mul_loose(*s, g), g_inv);
            if (j > 0) g = gl_mul_loose(g, mid[(long long)(j - 1) * n]);
        }
    }
    u64 total;
    const u64 before = block_scan<ROWS>(quot, warp_tot, total);
    if (t < n) z[kc * n + t] = before;
    if (threadIdx.x == 0) totals[kc * nb + b] = total;
}

// Pass B.  One block per (proof, challenge) (blockIdx.x = k * C + c):
// totals [K * C, nb] <- the product of the totals before each (loose);
// wrap [K * C] <- the product of all (canonical).
__global__ void __launch_bounds__(SCAN)
perm_columns_carries_kernel(u64* __restrict__ totals, u64* __restrict__ wrap, long long nb) {
    __shared__ u64 warp_tot[SCAN / WARP];
    u64* tot = totals + (long long)blockIdx.x * nb;
    u64 carry = 1;
    for (long long base = 0; base < nb; base += SCAN) {
        const long long i = base + threadIdx.x;
        u64 step;
        const u64 before = block_scan<SCAN>(i < nb ? tot[i] : 1, warp_tot, step);
        if (i < nb) tot[i] = gl_mul_loose(carry, before);
        carry = gl_mul_loose(carry, step);
    }
    if (threadIdx.x == 0) wrap[blockIdx.x] = gl_canon(carry);
}

// Pass C.  Grid (nb, C, K): z [K, C, n] <- carry * z; pp [K, C, nch - 1, n]
// <- z * q_j; both canonical.  carries [K, C, nb].
__global__ void __launch_bounds__(ROWS)
perm_columns_finish_kernel(u64* __restrict__ z, u64* __restrict__ pp,
                           const u64* __restrict__ carries, int nch, long long n) {
    const long long t = (long long)blockIdx.x * ROWS + threadIdx.x;
    if (t >= n) return;
    const long long kc = (long long)blockIdx.z * gridDim.y + blockIdx.y;
    const u64 zt = gl_canon(gl_mul_loose(carries[kc * gridDim.x + blockIdx.x], z[kc * n + t]));
    z[kc * n + t] = zt;
    u64* q = pp + kc * (nch - 1) * n + t;
#pragma unroll 4
    for (int j = 0; j < nch - 1; ++j) q[(long long)j * n] = gl_canon(gl_mul_loose(zt, q[(long long)j * n]));
}

extern "C" {

// The points per block of passes A and C: the wrapper sizes `totals` by it.
int perm_columns_row_block(void) { return ROWS; }

// nb, the number of blocks of ROWS points (the last dimension of `totals`),
// is the caller's; a count other than ceil(n / ROWS) is refused.
int perm_columns_rows(const void* wires, long long wires_k_stride, long long wires_row_stride,
                      const void* id_vals, const void* sigma, const void* betas,
                      const void* gammas, void* z, void* pp, void* g_mid, void* totals, int K,
                      int C, int R, int nch, long long n, long long nb, void* stream) {
    if (nb != (n + ROWS - 1) / ROWS) return (int)cudaErrorInvalidValue;
    dim3 grid((unsigned int)(nb * C), (unsigned int)K);
    perm_columns_rows_kernel<<<grid, ROWS, 0, (cudaStream_t)stream>>>(
        (const u64*)wires, wires_k_stride, wires_row_stride, (const u64*)id_vals,
        (const u64*)sigma, (const u64*)betas, (const u64*)gammas, (u64*)z, (u64*)pp,
        (u64*)g_mid, (u64*)totals, C, R, nch, n);
    return (int)cudaGetLastError();
}

int perm_columns_carries(void* totals, void* wrap, int K, int C, long long nb, void* stream) {
    perm_columns_carries_kernel<<<(unsigned int)K * (unsigned int)C, SCAN, 0, (cudaStream_t)stream>>>(
        (u64*)totals, (u64*)wrap, nb);
    return (int)cudaGetLastError();
}

int perm_columns_finish(void* z, void* pp, const void* carries, int K, int C, int nch, long long n,
                        long long nb, void* stream) {
    dim3 grid((unsigned int)nb, (unsigned int)C, (unsigned int)K);
    perm_columns_finish_kernel<<<grid, ROWS, 0, (cudaStream_t)stream>>>(
        (u64*)z, (u64*)pp, (const u64*)carries, nch, n);
    return (int)cudaGetLastError();
}

}  // extern "C"
