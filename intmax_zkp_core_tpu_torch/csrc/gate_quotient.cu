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
// Design: one thread per (proof, point) evaluates all 123 constraints in
// registers and folds each into its C running sums as soon as it exists, so
// no constraint array is ever stored; then it multiplies by the selector and
// adds acc.  Neighbouring threads read neighbouring points of each wire row,
// so every wire load is coalesced.  The twelve-lane state lives in
// registers; Y and the x_i, which the affine tables index by number, live in
// the thread's own column of shared memory.  The tables are stored sparse,
// as (basis index, constant) lists uploaded once from the port's Python
// constants, so no constant is typed here.  The alpha table
// tbl[c, j] = apows * alpha^j is made by each block in shared memory before
// its threads start (C dependent chains of 123 multiplies, the plain
// version's order), and the blocks of point 0 write apows'.
//
// What bounds it on this card: about 8 thousand 32-bit multiply-adds per
// point (118 S-boxes, 7 MDS layers, ~900 table products, 124 C fold and
// selector multiplies) against 8 * (W + 1 + 2 C) bytes: the integer pipe, not
// memory.  The reckoning is in chip_smoke.py::gate_quotient_bound.
//
// The arithmetic mirrors the plain PyTorch version
// (ops/gate_quotient_cuda.py::poseidon_gate_quotient_plain, built on
// PoseidonGate.eval_constraints_batched) formula by formula; the order of the
// alpha fold and of the table sums differs, which changes no value because
// every operation is exact mod p.
#include "poseidon_round.cuh"

#define THREADS 128
#define N_CS 123           // constraints of the gate
#define MAX_C 4            // challenges a launch takes
#define BASIS 34           // Y_0..Y_11, x_0..x_21
#define TABLE_ROWS 34      // PARTIAL_A rows 0..21, then PARTIAL_B rows 0..11
#define TABLE_CAP (TABLE_ROWS * BASIS)

// Wire layout of the gate (PoseidonGate.W_*), uploaded with the constants.
enum { L_IN, L_OUT, L_SWAP, L_DELTA, L_FULL1, L_PARTIAL, L_S26, L_FULL2, N_LAYOUT };
static __constant__ int c_layout[N_LAYOUT];
// Affine table row r: c_tab_const[r] + sum over e in [start[r], start[r+1])
// of basis[c_tab_index[e]] * c_tab_coef[e].
static __constant__ u64 c_tab_const[TABLE_ROWS];
static __constant__ int c_tab_start[TABLE_ROWS + 1];
static __constant__ unsigned char c_tab_index[TABLE_CAP];
static __constant__ u64 c_tab_coef[TABLE_CAP];

__device__ __forceinline__ void fold(u64 (&comb)[MAX_C], const u64* tbl, int C, int j, u64 v) {
#pragma unroll
    for (int c = 0; c < MAX_C; ++c)
        if (c < C) comb[c] = gl_add(comb[c], gl_mul(tbl[c * N_CS + j], v));
}

__device__ __forceinline__ u64 table_row(int r, const u64* basis) {
    u64 acc = c_tab_const[r];
    for (int e = c_tab_start[r]; e < c_tab_start[r + 1]; ++e)
        acc = gl_add(acc, gl_mul(basis[c_tab_index[e] * THREADS], c_tab_coef[e]));
    return acc;
}

// wires: element (k, w, t) at wires[k * wires_k_stride + w * wires_row_stride + t];
// sel [L], acc and out [K, C, L], alphas, apows and apows_out [K, C] contiguous.
// Dynamic shared memory: (C * N_CS + BASIS * THREADS) u64.
__global__ void __launch_bounds__(THREADS)
gate_quotient_kernel(const u64* __restrict__ wires, long long wires_k_stride,
                     long long wires_row_stride, const u64* __restrict__ sel,
                     const u64* __restrict__ alphas, const u64* __restrict__ acc,
                     const u64* __restrict__ apows, u64* __restrict__ out,
                     u64* __restrict__ apows_out, int C, long long L) {
    extern __shared__ u64 shared[];
    u64* tbl = shared;                                  // [C, N_CS]
    const long long k = blockIdx.y;
    for (int c = threadIdx.x; c < C; c += blockDim.x) {
        const u64 alpha = alphas[k * C + c];
        u64 p = apows[k * C + c];
        for (int j = 0; j < N_CS; ++j) {
            tbl[c * N_CS + j] = p;
            p = gl_mul(p, alpha);
        }
        if (blockIdx.x == 0) apows_out[k * C + c] = p;
    }
    __syncthreads();

    const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    if (t >= L) return;
    const u64* w = wires + k * wires_k_stride + t;
#define WIRE(i) w[(long long)(i) * wires_row_stride]
    u64* basis = shared + C * N_CS + threadIdx.x;       // entry e at basis[e * THREADS]
    u64 comb[MAX_C];
#pragma unroll
    for (int c = 0; c < MAX_C; ++c) comb[c] = 0;
    int j = 0;

    // the swap flag is boolean; delta_i = swap * (in[4+i] - in[i])
    const u64 swap = WIRE(c_layout[L_SWAP]);
    fold(comb, tbl, C, j++, gl_sub(gl_mul(swap, swap), swap));
    u64 s[T];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
        const u64 lo = WIRE(c_layout[L_IN] + i), hi = WIRE(c_layout[L_IN] + 4 + i);
        const u64 delta = WIRE(c_layout[L_DELTA] + i);
        fold(comb, tbl, C, j++, gl_sub(delta, gl_mul(swap, gl_sub(hi, lo))));
        s[i] = gl_add(lo, delta);
        s[4 + i] = gl_sub(hi, delta);
    }
#pragma unroll
    for (int i = 8; i < T; ++i) s[i] = WIRE(c_layout[L_IN] + i);

    // full rounds 0..2: the next state is materialized as wires
#pragma unroll 1
    for (int r = 0; r < 3; ++r) {
        full_round(s, r);
#pragma unroll
        for (int i = 0; i < T; ++i) {
            const u64 tgt = WIRE(c_layout[L_FULL1] + T * r + i);
            fold(comb, tbl, C, j++, gl_sub(tgt, s[i]));
            s[i] = tgt;
        }
    }
    // round 3: Y = the S-box outputs
#pragma unroll
    for (int i = 0; i < T; ++i)
        basis[i * THREADS] = gl_sbox7(gl_add(s[i], c_round_constants[3 * T + i]));
    // partial rounds: b_i against PARTIAL_A, x_i = sbox(b_i)
#pragma unroll 1
    for (int r = 0; r < N_PARTIAL; ++r) {
        const u64 b = WIRE(c_layout[L_PARTIAL] + r);
        fold(comb, tbl, C, j++, gl_sub(b, table_row(r, basis)));
        basis[(T + r) * THREADS] = gl_sbox7(b);
    }
    // the state before round 26 against PARTIAL_B
#pragma unroll 1
    for (int lane = 0; lane < T; ++lane)
        fold(comb, tbl, C, j++, gl_sub(WIRE(c_layout[L_S26] + lane), table_row(N_PARTIAL + lane, basis)));
    // full rounds 26..28 against their state wires, round 29 against the output
#pragma unroll
    for (int i = 0; i < T; ++i) s[i] = WIRE(c_layout[L_S26] + i);
#pragma unroll 1
    for (int r = 0; r < 4; ++r) {
        full_round(s, HALF_FULL + N_PARTIAL + r);
        const int base = r < 3 ? c_layout[L_FULL2] + T * r : c_layout[L_OUT];
#pragma unroll
        for (int i = 0; i < T; ++i) {
            const u64 tgt = WIRE(base + i);
            fold(comb, tbl, C, j++, gl_sub(tgt, s[i]));
            s[i] = tgt;
        }
    }
#undef WIRE

    const u64 sv = sel[t];
#pragma unroll
    for (int c = 0; c < MAX_C; ++c)
        if (c < C) out[(k * C + c) * L + t] = gl_add(acc[(k * C + c) * L + t], gl_mul(comb[c], sv));
}

extern "C" {

// Upload the constants (host arrays): the Poseidon round constants and MDS
// (poseidon_round.cuh), the gate's wire layout [N_LAYOUT], and the affine
// tables as TABLE_ROWS constant terms, TABLE_ROWS + 1 row starts and
// n_entries (basis index, coefficient) pairs.  Called once after loading.
int gate_quotient_set_constants(const u64* round_constants, const u64* mds_circ, u64 mds_diag0,
                                const long long* layout, const u64* tab_const,
                                const long long* tab_start, const long long* tab_index,
                                const u64* tab_coef, int n_entries) {
    if (n_entries < 0 || n_entries > TABLE_CAP) return (int)cudaErrorInvalidValue;
    int err = poseidon_round_upload(round_constants, mds_circ, mds_diag0);
    if (err != 0) return err;
    int lay[N_LAYOUT], start[TABLE_ROWS + 1];
    unsigned char index[TABLE_CAP];
    for (int i = 0; i < N_LAYOUT; ++i) lay[i] = (int)layout[i];
    for (int r = 0; r <= TABLE_ROWS; ++r) start[r] = (int)tab_start[r];
    for (int e = 0; e < n_entries; ++e) {
        if (tab_index[e] < 0 || tab_index[e] >= BASIS) return (int)cudaErrorInvalidValue;
        index[e] = (unsigned char)tab_index[e];
    }
    cudaError_t e1 = cudaMemcpyToSymbol(c_layout, lay, sizeof(lay));
    if (e1 == cudaSuccess) e1 = cudaMemcpyToSymbol(c_tab_const, tab_const, sizeof(u64) * TABLE_ROWS);
    if (e1 == cudaSuccess) e1 = cudaMemcpyToSymbol(c_tab_start, start, sizeof(start));
    if (e1 == cudaSuccess && n_entries > 0) {
        e1 = cudaMemcpyToSymbol(c_tab_index, index, n_entries);
        if (e1 == cudaSuccess) e1 = cudaMemcpyToSymbol(c_tab_coef, tab_coef, sizeof(u64) * n_entries);
    }
    return (int)e1;
}

int gate_quotient(const void* wires, long long wires_k_stride, long long wires_row_stride,
                  const void* sel, const void* alphas, const void* acc, const void* apows,
                  void* out, void* apows_out, int K, int C, long long L, void* stream) {
    if (C < 1 || C > MAX_C) return (int)cudaErrorInvalidValue;
    dim3 grid((unsigned int)((L + THREADS - 1) / THREADS), (unsigned int)K);
    size_t shared_bytes = sizeof(u64) * ((size_t)C * N_CS + (size_t)BASIS * THREADS);
    gate_quotient_kernel<<<grid, THREADS, shared_bytes, (cudaStream_t)stream>>>(
        (const u64*)wires, wires_k_stride, wires_row_stride, (const u64*)sel,
        (const u64*)alphas, (const u64*)acc, (const u64*)apows, (u64*)out, (u64*)apows_out,
        C, L);
    return (int)cudaGetLastError();
}

}  // extern "C"
