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
// Design: a thread takes POINTS points of one proof, THREADS apart, so that
// a warp reads and writes whole contiguous segments (comb1, comb2 and G
// interleaved [L, 2]: one 16-byte pair a point).  x lies in the base field,
// so the inverse of a denominator d = (x - z0) - z1*X is conj(d) / N with
// the base-field norm N = (x - z0)^2 - 7*z1^2.  The block inverts the two
// norms of all its points together (goldilocks.cuh::batch_inv_loose: each
// thread's running product, one Fermat chain for the block's product, three
// multiplies for each further norm).  A zero norm (zeta in the base field
// and equal to x) gives a zero inverse, so that term is 0 at that point only,
// as in the plain version.  7*z1^2 and 7*z1 are formed once a thread.  Each
// point's two terms go into two unreduced sums (GlDot), one per output
// lane, each reduced once.  A thread loads all its inputs before the chain,
// so that their reads overlap it.  All arithmetic is loose; each output lane
// is made canonical once, at the store.
//
// What bounds it on this card: per point it moves 56 bytes against two
// squarings, 6 multiplies of the batch inverse, 6 for the inverses'
// components, 8 products in the sums and a share of the block's scans and
// its chain.  Two Fermat chains per point (an earlier form of this kernel)
// made it issue-bound at some 18x its byte time.  Now the chain's latency,
// which the block waits for, the term arithmetic and the memory phases are
// what is left: a copy of the same bytes takes two thirds of its time
// (PERF.md).
//
// The values equal the plain PyTorch version's
// (ops/fri_init_cuda.py::fri_initial_plain) bit for bit: every step is exact
// mod p (tests/test_torch_fri_init.py replays this schedule in Python ints).
#include <cuda_runtime.h>

#include "goldilocks.cuh"

#define THREADS 128
#define POINTS 4  // points a thread

// comb1, comb2, out [K, L, 2] contiguous and 16-byte aligned; xs [L];
// zetas, gzetas, c1z, c2gz [K, 2] contiguous.  Grid (blocks of points, K).
__global__ void __launch_bounds__(THREADS)
fri_initial_kernel(const ulonglong2* __restrict__ comb1, const ulonglong2* __restrict__ comb2,
                   const u64* __restrict__ xs, const u64* __restrict__ zetas,
                   const u64* __restrict__ gzetas, const u64* __restrict__ c1z,
                   const u64* __restrict__ c2gz, ulonglong2* __restrict__ out, long long L) {
    const long long k = blockIdx.y;
    const long long t0 = (long long)blockIdx.x * (THREADS * POINTS) + threadIdx.x;
    // term a: 1 / (x - zeta), term b: 1 / (x - g*zeta); w = 7 z1^2 canonical
    // (gl_sub_loose takes it), s = 7 z1
    const u64 za0 = zetas[2 * k], za1 = zetas[2 * k + 1];
    const u64 zb0 = gzetas[2 * k], zb1 = gzetas[2 * k + 1];
    const u64 wa = gl_canon(gl_mul_loose(gl_sqr_loose(za1), 7));
    const u64 wb = gl_canon(gl_mul_loose(gl_sqr_loose(zb1), 7));

    u64 x[POINTS], inv[2 * POINTS];  // inv: the norms of terms a and b, then their inverses
    ulonglong2 a[POINTS], b[POINTS];   // comb1(x), comb2(x), loaded before the chain
#pragma unroll
    for (int i = 0; i < POINTS; ++i) {
        const long long t = t0 + i * THREADS;
        if (t < L) {
            a[i] = comb1[k * L + t];
            b[i] = comb2[k * L + t];
        }
        x[i] = t < L ? xs[t] : 0;
        inv[2 * i] = t < L ? gl_sub_loose(gl_sqr_loose(gl_sub_loose(x[i], za0)), wa) : 1;
        inv[2 * i + 1] = t < L ? gl_sub_loose(gl_sqr_loose(gl_sub_loose(x[i], zb0)), wb) : 1;
    }
    batch_inv_loose<THREADS>(inv);

    const u64 sa = gl_mul_loose(za1, 7), sb = gl_mul_loose(zb1, 7);
    const u64 ca0 = c1z[2 * k], ca1 = c1z[2 * k + 1], cb0 = c2gz[2 * k], cb1 = c2gz[2 * k + 1];
#pragma unroll
    for (int i = 0; i < POINTS; ++i) {
        const long long t = t0 + i * THREADS;
        if (t >= L) continue;
        // (n0 + n1 X) (d0 + z1 X) / N = (n0 d0 + 7 n1 z1) / N + (n0 z1 + n1 d0) / N X
        const u64 da = gl_sub_loose(x[i], za0), db = gl_sub_loose(x[i], zb0);
        const u64 na0 = gl_sub_loose(a[i].x, ca0), na1 = gl_sub_loose(a[i].y, ca1);
        const u64 nb0 = gl_sub_loose(b[i].x, cb0), nb1 = gl_sub_loose(b[i].y, cb1);
        const u64 ia0 = gl_mul_loose(da, inv[2 * i]), ia1 = gl_mul_loose(za1, inv[2 * i]);
        const u64 ib0 = gl_mul_loose(db, inv[2 * i + 1]), ib1 = gl_mul_loose(zb1, inv[2 * i + 1]);
        GlDot g0, g1;
        g0.mac(na0, ia0);
        g0.mac(na1, gl_mul_loose(sa, inv[2 * i]));
        g0.mac(nb0, ib0);
        g0.mac(nb1, gl_mul_loose(sb, inv[2 * i + 1]));
        g1.mac(na0, ia1);
        g1.mac(na1, ia0);
        g1.mac(nb0, ib1);
        g1.mac(nb1, ib0);
        ulonglong2 g;
        g.x = gl_canon(gl_dot_reduce(g0));
        g.y = gl_canon(gl_dot_reduce(g1));
        out[k * L + t] = g;
    }
}

extern "C" {

// The batch layout: THREADS threads a block, POINTS points a thread, which
// lie THREADS apart (chip_smoke.py plants zero norms in one thread's points
// by it).
int fri_initial_threads(void) { return THREADS; }
int fri_initial_points(void) { return POINTS; }

int fri_initial(const void* comb1, const void* comb2, const void* xs, const void* zetas,
                const void* gzetas, const void* c1z, const void* c2gz, void* out, long long K,
                long long L, void* stream) {
    dim3 grid((unsigned int)((L + THREADS * POINTS - 1) / (THREADS * POINTS)), (unsigned int)K);
    fri_initial_kernel<<<grid, THREADS, 0, (cudaStream_t)stream>>>(
        (const ulonglong2*)comb1, (const ulonglong2*)comb2, (const u64*)xs, (const u64*)zetas,
        (const u64*)gzetas, (const u64*)c1z, (const u64*)c2gz, (ulonglong2*)out, L);
    return (int)cudaGetLastError();
}

}  // extern "C"
