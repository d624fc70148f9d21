// Poseidon-12 over Goldilocks for Hopper (sm_90a): the permutation kernel
// and the fused rate-8 sponge kernel.
//
// Replaces the JAX package's Pallas kernels
//   ops/poseidon_pallas.py::permute_pallas      -> poseidon_permute
//   ops/poseidon_pallas.py::hash_no_pad_pallas  -> poseidon_hash_no_pad
//
// Design: one thread per permutation, the twelve-lane state in 64-bit
// registers through 4 full rounds, 22 partial rounds and 4 full rounds.
// - The state is loose between rounds (any u64 standing for its residue mod
//   p) and each output lane is made canonical once, at the end
//   (goldilocks.cuh, the loose functions).  Products are four 32x32 partial
//   products in carry chains (three for a square); reductions are carry
//   chains too, with no general multiply and no compare.
// - A full round's constants are added to the state only on entry to each
//   half; within a half, the next round's constants are folded into the
//   MDS reduction (the TPU kernel's fold_rc_reduce).  The full-round MDS is
//   the small-constant limb product of poseidon_round.cuh.
// - The partial rounds run in the sparse form of ops/poseidon_fast.py
//   (permute_fast_s): FAST_PARTIAL_FIRST_RC folded into the last full
//   round of the first half, INIT_MATRIX's dense 11x11 block once, then per
//   round a lane-0 S-box, FAST_PARTIAL_RC[i], the dot product of
//   (M00, w_hat) with the state kept in three words and reduced once, and
//   the eleven v updates.
// - The sponge stages the next rate-8 chunk of its block's rows in shared
//   memory with cp.async while the current permutation runs, so no thread
//   waits on device memory between absorb steps and the copies are
//   coalesced for both layouts the prover hands over (the transposed
//   [width, B] view of an LDE and contiguous [B, 8] tree levels).
//
// The tables are uploaded from the port's Python constants
// (ops/poseidon_cuda.py::kernel_tables, which builds them in the order read
// here); no constant is typed in this file.
//
// What bounds it on this card: a permutation moves 192 bytes but needs
// about 6.4 thousand 32-bit multiply-adds (chip_smoke.py::MADS_PER_PERMUTATION)
// — the integer pipe, not memory, is the limit.
//
// The results are bit-identical to the plain PyTorch version
// (ops/poseidon.py), a mod-p function with canonical output, for every u64
// input: every step here is exact mod p and every output lane is canonical.
//
// Plain C interface, loaded with ctypes: each launcher returns
// cudaGetLastError() so that the Python wrapper can raise (runtime.cu turns
// the code into text).
#include "poseidon_round.cuh"

#define RATE 8
#define THREADS 128
// A hint of three resident blocks: ptxas then takes 110 registers and spills
// nothing, where without it it takes 96 and spills (the launch shapes tried
// are in experiments/poseidon_cuda_variants.py, their times in PERF.md).
#define MIN_BLOCKS 3
#define FULL_ROWS 5        // per half: the entry constants, then one fold per full round
#define SPARSE_ROW 24      // per partial round: rc, M00, w_hat[11], v[11]
#define STAGE_PITCH 9      // u64 per staged row: 8 lanes and a pad against bank conflicts

static __constant__ u64 c_full_rc[2 * FULL_ROWS * T];
static __constant__ u64 c_init[(T - 1) * (T - 1)];
static __constant__ u64 c_sparse[N_PARTIAL * SPARSE_ROW];

// MDS of the full round, with `fold` (the next round's constants) added
// before the reduction: loose in, loose out.
__device__ __forceinline__ void mds_fold(u64 (&s)[T], const u64* fold) {
    unsigned int lo[T], hi[T];
#pragma unroll
    for (int i = 0; i < T; ++i) {
        lo[i] = (unsigned int)s[i];
        hi[i] = (unsigned int)(s[i] >> 32);
    }
#pragma unroll
    for (int r = 0; r < T; ++r) {
        u64 acc_lo, acc_hi;
        mds_row(lo, hi, r, acc_lo, acc_hi);
        s[r] = gl_fold_reduce_loose(acc_lo, acc_hi, fold[r]);
    }
}

__device__ __forceinline__ void full_round_loose(u64 (&s)[T], const u64* fold) {
#pragma unroll
    for (int i = 0; i < T; ++i) s[i] = gl_sbox7_loose(s[i]);
    mds_fold(s, fold);
}

__device__ __forceinline__ void partial_rounds(u64 (&s)[T]) {
    // INIT_MATRIX: identity on lane 0, a dense block on lanes 1..11
    u64 t[T - 1];
#pragma unroll
    for (int i = 0; i < T - 1; ++i) {
        GlDot dot;
#pragma unroll
        for (int j = 0; j < T - 1; ++j) dot.mac(c_init[i * (T - 1) + j], s[1 + j]);
        u32 top;
        u64 hi, lo;
        dot.hi_lo(top, hi, lo);
        t[i] = gl_reduce160_loose(top, hi, lo);
    }
#pragma unroll
    for (int i = 0; i < T - 1; ++i) s[1 + i] = t[i];
#pragma unroll 1
    for (int rnd = 0; rnd < N_PARTIAL; ++rnd) {
        const u64* c = c_sparse + rnd * SPARSE_ROW;
        u64 s0 = gl_add_loose(gl_sbox7_loose(s[0]), c[0]);
        GlDot dot;
        dot.mac(c[1], s0);
#pragma unroll
        for (int j = 0; j < T - 1; ++j) dot.mac(c[2 + j], s[1 + j]);
#pragma unroll
        for (int j = 0; j < T - 1; ++j) {
            u64 hi, lo;
            gl_mul_add128(c[2 + (T - 1) + j], s0, s[1 + j], hi, lo);
            s[1 + j] = gl_reduce128_loose(hi, lo);
        }
        u32 top;
        u64 hi, lo;
        dot.hi_lo(top, hi, lo);
        s[0] = gl_reduce160_loose(top, hi, lo);
    }
}

// The permutation of a loose state; the result is loose.
__device__ __forceinline__ void permute_loose(u64 (&s)[T]) {
#pragma unroll 1
    for (int half = 0; half < 2; ++half) {
        const u64* c = c_full_rc + half * FULL_ROWS * T;
#pragma unroll
        for (int i = 0; i < T; ++i) s[i] = gl_add_loose(s[i], c[i]);
#pragma unroll 1
        for (int rnd = 1; rnd < FULL_ROWS; ++rnd) full_round_loose(s, c + rnd * T);
        if (half == 0) partial_rounds(s);
    }
}

// states [B, 12] contiguous -> out [B, 12] contiguous.
__global__ void __launch_bounds__(THREADS, MIN_BLOCKS)
permute_kernel(const u64* __restrict__ in, u64* __restrict__ out, long long B) {
    long long stride = (long long)gridDim.x * blockDim.x;
    for (long long row = (long long)blockIdx.x * blockDim.x + threadIdx.x; row < B; row += stride) {
        u64 s[T];
#pragma unroll
        for (int i = 0; i < T; ++i) s[i] = in[row * T + i];
        permute_loose(s);
#pragma unroll
        for (int i = 0; i < T; ++i) out[row * T + i] = gl_canon(s[i]);
    }
}

// Asynchronous 8-byte copy from device memory to shared memory, and the
// commit / wait of such copies by groups.
__device__ __forceinline__ void cp_async8(u64* dst, const u64* src) {
    unsigned int d = (unsigned int)__cvta_generic_to_shared(dst);
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(d), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
    asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_one() {
    asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
    asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// Start the copies of one chunk (rows [base, base + n_rows), columns
// [col0, col0 + n_cols)) into stage[row - base][col - col0].  Neighbouring
// threads take neighbouring addresses of the input: along the rows when the
// row stride is the smaller one (a transposed view), else along the columns.
__device__ __forceinline__ void stage_chunk(u64* stage, const u64* __restrict__ in,
                                            long long row_stride, long long col_stride,
                                            long long base, int n_rows, int col0, int n_cols) {
    int n = n_rows * n_cols;
    bool rows_inner = row_stride <= col_stride;
    for (int e = threadIdx.x; e < n; e += THREADS) {
        int r = rows_inner ? e % n_rows : e / n_cols;
        int c = rows_inner ? e / n_rows : e % n_cols;
        cp_async8(stage + r * STAGE_PITCH + c,
                  in + (base + r) * row_stride + (long long)(col0 + c) * col_stride);
    }
    cp_async_commit();
}

// inputs [B, width] with element (row, col) at in[row * row_stride + col *
// col_stride] -> out [B, 4] contiguous.  Zero state, overwrite-absorb in
// rate-8 chunks, one permutation per chunk.  Each block takes THREADS rows
// at a time; chunk k + 1 is copied into the other half of the double buffer
// while chunk k is permuted.  A partial last chunk overwrites only its own
// lanes.
__global__ void __launch_bounds__(THREADS, MIN_BLOCKS)
hash_no_pad_kernel(const u64* __restrict__ in, long long row_stride, long long col_stride,
                   int width, u64* __restrict__ out, long long B) {
    __shared__ u64 stage[2][THREADS * STAGE_PITCH];
    const int n_chunks = (width + RATE - 1) / RATE;
    for (long long base = (long long)blockIdx.x * THREADS; base < B;
         base += (long long)gridDim.x * THREADS) {
        const int n_rows = (int)(B - base < THREADS ? B - base : THREADS);
        const bool live = threadIdx.x < n_rows;
        u64 s[T];
#pragma unroll
        for (int i = 0; i < T; ++i) s[i] = 0;
        stage_chunk(stage[0], in, row_stride, col_stride, base, n_rows, 0,
                    width < RATE ? width : RATE);
        for (int k = 0; k < n_chunks; ++k) {
            if (k + 1 < n_chunks) {
                int col0 = (k + 1) * RATE;
                stage_chunk(stage[(k + 1) & 1], in, row_stride, col_stride, base, n_rows, col0,
                            width - col0 < RATE ? width - col0 : RATE);
                cp_async_wait_one();
            } else {
                cp_async_wait_all();
            }
            __syncthreads();  // chunk k is in shared memory for every thread
            const int n_cols = width - k * RATE < RATE ? width - k * RATE : RATE;
            if (live) {
                const u64* mine = stage[k & 1] + threadIdx.x * STAGE_PITCH;
#pragma unroll
                for (int j = 0; j < RATE; ++j)
                    if (j < n_cols) s[j] = mine[j];
            }
            __syncthreads();  // every thread has read chunk k before its buffer is refilled
            permute_loose(s);
        }
        if (live) {
#pragma unroll
            for (int i = 0; i < 4; ++i) out[(base + threadIdx.x) * 4 + i] = gl_canon(s[i]);
        }
    }
}

static int grid_for(long long B) {
    int device = 0, sms = 0;
    cudaGetDevice(&device);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
    long long blocks = (B + THREADS - 1) / THREADS;
    long long cap = (long long)sms * 16;
    if (blocks > cap) blocks = cap;
    if (blocks < 1) blocks = 1;
    return (int)blocks;
}

extern "C" {

// Upload the constants (host arrays, ops/poseidon_cuda.py::set_constants):
// the 12 circulant entries and the one non-zero diagonal entry of the MDS
// (poseidon_round.cuh), then this kernel's tables: full_rc [2, FULL_ROWS,
// 12], init [11, 11], sparse [22, SPARSE_ROW].  Called once after loading.
int poseidon_set_constants(const u64* mds_circ, u64 mds_diag0, const u64* full_rc,
                           const u64* init, const u64* sparse) {
    int err = poseidon_mds_upload(mds_circ, mds_diag0);
    if (err != 0) return err;
    cudaError_t e = cudaMemcpyToSymbol(c_full_rc, full_rc, sizeof(c_full_rc));
    if (e == cudaSuccess) e = cudaMemcpyToSymbol(c_init, init, sizeof(c_init));
    if (e == cudaSuccess) e = cudaMemcpyToSymbol(c_sparse, sparse, sizeof(c_sparse));
    return (int)e;
}

int poseidon_permute(const void* in, void* out, long long B, void* stream) {
    permute_kernel<<<grid_for(B), THREADS, 0, (cudaStream_t)stream>>>(
        (const u64*)in, (u64*)out, B);
    return (int)cudaGetLastError();
}

int poseidon_hash_no_pad(const void* in, long long row_stride, long long col_stride, int width,
                         void* out, long long B, void* stream) {
    hash_no_pad_kernel<<<grid_for(B), THREADS, 0, (cudaStream_t)stream>>>(
        (const u64*)in, row_stride, col_stride, width, (u64*)out, B);
    return (int)cudaGetLastError();
}

}  // extern "C"
