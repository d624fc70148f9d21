// The Poseidon gate's share of the quotient for Hopper (sm_90a): per proof k,
// challenge c and LDE point x,
//
//   acc'[k, c, x] = acc[k, c, x] + sel(x) * sum_j apows[k, c] * alphas[k, c]^j * t_j(x)
//   apows'[k, c]  = apows[k, c] * alphas[k, c]^123
//
// with t_0 .. t_122 the constraints of engine/gates.py::PoseidonGate, in its
// order: the swap flag, the four deltas, full rounds 0-2 against their
// state wires, the 22 partial-round S-box inputs and the state before round
// 26 through the affine tables PARTIAL_A / PARTIAL_B over
// [1, Y_0..Y_11, x_0..x_21] (Y = the S-box outputs of round 3, x_i =
// sbox(b_i)), full rounds 26-28 and round 29 against the output wires.
//
// Replaces the JAX package's Pallas kernels
//   ops/gate_quotient_pallas.py::poseidon_gate_quotient_pallas          -> gate_quotient
//   ops/gate_quotient_pallas.py::poseidon_gate_quotient_pallas_batched  -> gate_quotient
// (one kernel for both: K = 1 is the single-proof form).
//
// Design: one thread per (proof, point) evaluates all 123 constraints and
// folds each into its C sums as soon as it exists, so no constraint array
// is ever stored; then it multiplies by the selector and adds acc.
// Neighbouring threads read neighbouring points of each wire row, so every
// wire load is coalesced.  The kernel is a template on C (1 to 4), so the
// sums are registers with no guard.
//   - Sums reduced once.  Each of the C alpha folds is one GlDot
//     (goldilocks.cuh: a 160-bit sum of 64x64 products, no reduction per
//     term) over the 123 constraints, reduced once at the end; each row of
//     PARTIAL_A / PARTIAL_B is one GlDot over its basis terms, reduced once.
//     Registers: 8 u32 per GlDot, 8 C for the folds (32 at C = 4).
//   - Loose Poseidon.  The S-boxes, round constants and MDS rows of the
//     seven full rounds and the 34 S-boxes of the basis run on loose values
//     (any u64 standing for its residue): gl_sbox7_loose, gl_add_loose,
//     poseidon_round.cuh::mds_row reduced by gl_fold_reduce_loose.  A
//     constraint t_j may stay loose (a GlDot takes any u64); a difference
//     takes its subtrahend canonical (gl_sub_loose).
//   - The alpha table tbl[c, j] = apows * alpha^j (j <= 123; j = 123 is
//     apows') is made by each block in shared memory, one entry per thread
//     by square-and-multiply: seven squarings at most, no serial chain.
//   - The tables' shape is fixed: row r < 22 of PARTIAL_A reads Y and
//     x_0 .. x_{r-1}, each row of PARTIAL_B all 34 basis terms.  The rows
//     are stored dense ([34, 34] in __constant__, zero beyond a row's
//     shape), uploaded once from the port's Python constants, so no constant
//     is typed here.  Y stays in registers, the x_i in the thread's column
//     of shared memory; the twelve Y terms of a row are unrolled, the x terms
//     run in a loop over the row's length, two at a time (other unrolling,
//     and rows two at a time, measured slower: experiments/ntt_gate_variants.py
//     and PERF.md).
//
// What bounds it on this card: about 8 thousand 32-bit multiply-adds per
// point (118 S-boxes, 7 MDS layers, ~900 table products, 123 C fold and C
// selector multiplies) against 8 * (W + 1 + 2 C) bytes: the integer pipe, not
// memory.  The reckoning is in chip_smoke.py::gate_quotient_bound.
//
// The values equal the plain PyTorch version's
// (ops/gate_quotient_cuda.py::poseidon_gate_quotient_plain, built on
// PoseidonGate.eval_constraints_batched): every operation is exact mod p, so
// the order of the sums, the loose intermediates and the one reduction per
// sum change no value (tests/test_torch_gate_quotient.py replays this
// kernel's order in Python ints).
#include "poseidon_round.cuh"

#define THREADS 256
#define N_CS 123           // constraints of the gate
#define BASIS 34           // Y_0..Y_11, x_0..x_21
#define TABLE_ROWS 34      // PARTIAL_A rows 0..21, then PARTIAL_B rows 0..11

// Wire layout of the gate (PoseidonGate.W_*), uploaded with the constants.
enum { L_IN, L_OUT, L_SWAP, L_DELTA, L_FULL1, L_PARTIAL, L_S26, L_FULL2, N_LAYOUT };
static __constant__ int c_layout[N_LAYOUT];
// Affine table row r: c_tab_const[r] + sum_e c_tab_coef[r * BASIS + e] * basis[e].
static __constant__ u64 c_tab_const[TABLE_ROWS];
static __constant__ u64 c_tab_coef[TABLE_ROWS * BASIS];

// Fold constraint j into the C sums: comb[c] += tbl[c, j] * v.
template <int C>
__device__ __forceinline__ void fold(GlDot (&comb)[C], const u64* tbl, int j, u64 v) {
#pragma unroll
    for (int c = 0; c < C; ++c) comb[c].mac(tbl[c * (N_CS + 1) + j], v);
}

// Table row r over Y (registers) and the first n_x of the x_i (shared
// memory, entry i at x[i * THREADS]): loose.
__device__ __forceinline__ u64 table_row(int r, const u64 (&y)[T], const u64* x, int n_x) {
    GlDot d;
    const u64* coef = c_tab_coef + r * BASIS;
#pragma unroll
    for (int i = 0; i < T; ++i) d.mac(y[i], coef[i]);
#pragma unroll 2
    for (int i = 0; i < n_x; ++i) d.mac(x[i * THREADS], coef[T + i]);
    return gl_add_loose(gl_dot_reduce(d), c_tab_const[r]);
}

// s <- MDS * sbox(s + rc[rnd]) on all twelve lanes, loose in and out.
__device__ __forceinline__ void full_round_loose(u64 (&s)[T], int rnd) {
    unsigned int lo[T], hi[T];
#pragma unroll
    for (int i = 0; i < T; ++i) {
        const u64 v = gl_sbox7_loose(gl_add_loose(s[i], c_round_constants[rnd * T + i]));
        lo[i] = (unsigned int)v;
        hi[i] = (unsigned int)(v >> 32);
    }
#pragma unroll
    for (int r = 0; r < T; ++r) {
        u64 acc_lo, acc_hi;
        mds_row(lo, hi, r, acc_lo, acc_hi);
        s[r] = gl_fold_reduce_loose(acc_lo, acc_hi, 0);
    }
}

// The next state's twelve wires against s: t = wire - s, folded; s <- the wires.
template <int C>
__device__ __forceinline__ void state_against(GlDot (&comb)[C], const u64* tbl, int& j, u64 (&s)[T],
                                              const u64* w, long long row_stride, int base) {
#pragma unroll
    for (int i = 0; i < T; ++i) {
        const u64 tgt = w[(long long)(base + i) * row_stride];
        fold(comb, tbl, j++, gl_sub_loose(tgt, gl_canon(s[i])));
        s[i] = tgt;
    }
}

// wires: element (k, w, t) at wires[k * wires_k_stride + w * wires_row_stride + t];
// sel [L], acc and out [K, C, L], alphas, apows and apows_out [K, C] contiguous.
// Dynamic shared memory: (C * (N_CS + 1) + N_PARTIAL * THREADS) u64.
template <int C>
__global__ void __launch_bounds__(THREADS)
gate_quotient_kernel(const u64* __restrict__ wires, long long wires_k_stride,
                     long long wires_row_stride, const u64* __restrict__ sel,
                     const u64* __restrict__ alphas, const u64* __restrict__ acc,
                     const u64* __restrict__ apows, u64* __restrict__ out,
                     u64* __restrict__ apows_out, long long L) {
    extern __shared__ u64 shared[];
    u64* tbl = shared;  // [C, N_CS + 1]: apows * alpha^j
    const long long k = blockIdx.y;
    for (int e = threadIdx.x; e < C * (N_CS + 1); e += THREADS) {
        const int c = e / (N_CS + 1), j = e % (N_CS + 1);
        u64 base = alphas[k * C + c], p = apows[k * C + c];
#pragma unroll 1
        for (int bits = j; bits != 0; bits >>= 1) {
            if (bits & 1) p = gl_mul(p, base);
            base = gl_mul(base, base);
        }
        tbl[e] = p;
        if (j == N_CS && blockIdx.x == 0) apows_out[k * C + c] = p;
    }
    __syncthreads();

    const long long t = (long long)blockIdx.x * THREADS + threadIdx.x;
    if (t >= L) return;
    const u64* w = wires + k * wires_k_stride + t;
#define WIRE(i) w[(long long)(i) * wires_row_stride]
    u64* x = shared + C * (N_CS + 1) + threadIdx.x;  // x_i at x[i * THREADS]
    GlDot comb[C];
    int j = 0;

    // the swap flag is boolean; delta_i = swap * (in[4+i] - in[i])
    const u64 swap = WIRE(c_layout[L_SWAP]);
    fold(comb, tbl, j++, gl_sub(gl_mul(swap, swap), swap));
    u64 s[T];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
        const u64 lo = WIRE(c_layout[L_IN] + i), hi = WIRE(c_layout[L_IN] + 4 + i);
        const u64 delta = WIRE(c_layout[L_DELTA] + i);
        fold(comb, tbl, j++, gl_sub(delta, gl_mul(swap, gl_sub(hi, lo))));
        s[i] = gl_add(lo, delta);
        s[4 + i] = gl_sub(hi, delta);
    }
#pragma unroll
    for (int i = 8; i < T; ++i) s[i] = WIRE(c_layout[L_IN] + i);

    // full rounds 0..2: the next state is materialized as wires
#pragma unroll 1
    for (int r = 0; r < 3; ++r) {
        full_round_loose(s, r);
        state_against(comb, tbl, j, s, w, wires_row_stride, c_layout[L_FULL1] + T * r);
    }
    // round 3: Y = the S-box outputs
    u64 y[T];
#pragma unroll
    for (int i = 0; i < T; ++i) y[i] = gl_sbox7_loose(gl_add_loose(s[i], c_round_constants[3 * T + i]));
    // partial rounds: b_r against row r of PARTIAL_A, x_r = sbox(b_r)
#pragma unroll 1
    for (int r = 0; r < N_PARTIAL; ++r) {
        const u64 b = WIRE(c_layout[L_PARTIAL] + r);
        fold(comb, tbl, j++, gl_sub_loose(b, gl_canon(table_row(r, y, x, r))));
        x[r * THREADS] = gl_sbox7_loose(b);
    }
    // the state before round 26 against PARTIAL_B
#pragma unroll 1
    for (int lane = 0; lane < T; ++lane)
        fold(comb, tbl, j++, gl_sub_loose(WIRE(c_layout[L_S26] + lane),
                                          gl_canon(table_row(N_PARTIAL + lane, y, x, N_PARTIAL))));
    // full rounds 26..28 against their state wires, round 29 against the output
#pragma unroll
    for (int i = 0; i < T; ++i) s[i] = WIRE(c_layout[L_S26] + i);
#pragma unroll 1
    for (int r = 0; r < 4; ++r) {
        full_round_loose(s, HALF_FULL + N_PARTIAL + r);
        state_against(comb, tbl, j, s, w, wires_row_stride,
                      r < 3 ? c_layout[L_FULL2] + T * r : c_layout[L_OUT]);
    }
#undef WIRE

    const u64 sv = sel[t];
#pragma unroll
    for (int c = 0; c < C; ++c)
        out[(k * C + c) * L + t] = gl_add(acc[(k * C + c) * L + t], gl_mul(gl_dot_reduce(comb[c]), sv));
}

template <int C>
static int launch(const void* wires, long long wires_k_stride, long long wires_row_stride,
                  const void* sel, const void* alphas, const void* acc, const void* apows,
                  void* out, void* apows_out, int K, long long L, void* stream) {
    dim3 grid((unsigned int)((L + THREADS - 1) / THREADS), (unsigned int)K);
    const size_t shared_bytes = sizeof(u64) * ((size_t)C * (N_CS + 1) + (size_t)N_PARTIAL * THREADS);
    // 47.9 KB at C = 4: above 48 KB only for a larger block, with this attribute
    cudaError_t err = cudaFuncSetAttribute(gate_quotient_kernel<C>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           (int)shared_bytes);
    if (err != cudaSuccess) return (int)err;
    gate_quotient_kernel<C><<<grid, THREADS, shared_bytes, (cudaStream_t)stream>>>(
        (const u64*)wires, wires_k_stride, wires_row_stride, (const u64*)sel,
        (const u64*)alphas, (const u64*)acc, (const u64*)apows, (u64*)out, (u64*)apows_out, L);
    return (int)cudaGetLastError();
}

extern "C" {

// Upload the constants (host arrays): the Poseidon round constants and MDS
// (poseidon_round.cuh), the gate's wire layout [N_LAYOUT], and the affine
// tables as TABLE_ROWS constant terms and [TABLE_ROWS, BASIS] dense
// coefficients.  Called once after loading.
int gate_quotient_set_constants(const u64* round_constants, const u64* mds_circ, u64 mds_diag0,
                                const long long* layout, const u64* tab_const,
                                const u64* tab_coef) {
    int err = poseidon_round_upload(round_constants, mds_circ, mds_diag0);
    if (err != 0) return err;
    int lay[N_LAYOUT];
    for (int i = 0; i < N_LAYOUT; ++i) lay[i] = (int)layout[i];
    cudaError_t e1 = cudaMemcpyToSymbol(c_layout, lay, sizeof(lay));
    if (e1 == cudaSuccess) e1 = cudaMemcpyToSymbol(c_tab_const, tab_const, sizeof(u64) * TABLE_ROWS);
    if (e1 == cudaSuccess)
        e1 = cudaMemcpyToSymbol(c_tab_coef, tab_coef, sizeof(u64) * TABLE_ROWS * BASIS);
    return (int)e1;
}

int gate_quotient(const void* wires, long long wires_k_stride, long long wires_row_stride,
                  const void* sel, const void* alphas, const void* acc, const void* apows,
                  void* out, void* apows_out, int K, int C, long long L, void* stream) {
    switch (C) {
        case 1: return launch<1>(wires, wires_k_stride, wires_row_stride, sel, alphas, acc, apows, out, apows_out, K, L, stream);
        case 2: return launch<2>(wires, wires_k_stride, wires_row_stride, sel, alphas, acc, apows, out, apows_out, K, L, stream);
        case 3: return launch<3>(wires, wires_k_stride, wires_row_stride, sel, alphas, acc, apows, out, apows_out, K, L, stream);
        case 4: return launch<4>(wires, wires_k_stride, wires_row_stride, sel, alphas, acc, apows, out, apows_out, K, L, stream);
    }
    return (int)cudaErrorInvalidValue;
}

}  // extern "C"
