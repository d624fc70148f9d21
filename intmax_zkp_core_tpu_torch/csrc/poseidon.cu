// Poseidon-12 over Goldilocks for Hopper (sm_90a): the permutation kernel
// and the fused rate-8 sponge kernel.
//
// Replaces the JAX package's Pallas kernels
//   ops/poseidon_pallas.py::permute_pallas      -> poseidon_permute
//   ops/poseidon_pallas.py::hash_no_pad_pallas  -> poseidon_hash_no_pad
//
// Design: one thread per permutation, the twelve-lane state in 64-bit
// registers through all 30 rounds (4 full, 22 partial, 4 full), a grid-stride
// loop over rows so any batch size B >= 1 runs without padding.  Round
// constants and the circulant MDS row sit in __constant__ memory: every
// thread of a warp reads the same entry, which the constant cache broadcasts.
//
// What bounds it on this card: a permutation moves 192 bytes (12 u64 in, 12
// out) but performs 8*12 + 22 = 118 S-boxes of four 64x64->128 multiplies
// each plus 30 MDS layers of 2*145 small multiplies — arithmetic on the
// integer pipe, not bytes, is the limit (see PERF.md for the reckoning).
//
// The arithmetic mirrors the plain PyTorch version (ops/poseidon.py) formula
// by formula, so results are bit-identical for every u64 input.
//
// Plain C interface, loaded with ctypes: each launcher returns
// cudaGetLastError() so that the Python wrapper can raise.
#include <cuda_runtime.h>

#include "goldilocks.cuh"

#define T 12
#define RATE 8
#define N_ROUNDS 30
#define HALF_FULL 4
#define N_PARTIAL 22
#define THREADS 128

__constant__ u64 c_round_constants[N_ROUNDS * T];
__constant__ unsigned int c_mds_circ[T];  // entries < 2^6: 32x32->64 multiply-adds suffice
__constant__ unsigned int c_mds_diag0;

// out[r] = sum_i CIRC[i] * s[(r + i) % 12]  (+ DIAG[0] * s[0] on lane 0),
// accumulated per 32-bit limb (each accumulator < 2^42), recombined to a
// (top, low) pair and reduced once per lane.
__device__ __forceinline__ void mds_layer(u64 (&s)[T]) {
    unsigned int lo[T], hi[T];
#pragma unroll
    for (int i = 0; i < T; ++i) {
        lo[i] = (unsigned int)s[i];
        hi[i] = (unsigned int)(s[i] >> 32);
    }
#pragma unroll
    for (int r = 0; r < T; ++r) {
        u64 acc_lo = 0, acc_hi = 0;
#pragma unroll
        for (int i = 0; i < T; ++i) {
            acc_lo += (u64)c_mds_circ[i] * lo[(r + i) % T];
            acc_hi += (u64)c_mds_circ[i] * hi[(r + i) % T];
        }
        if (r == 0) {
            acc_lo += (u64)c_mds_diag0 * lo[0];
            acc_hi += (u64)c_mds_diag0 * hi[0];
        }
        u64 low = acc_lo + (acc_hi << 32);
        u64 top = (acc_hi >> 32) + (low < acc_lo ? 1ULL : 0ULL);
        s[r] = gl_reduce128(top, low);
    }
}

__device__ __forceinline__ void full_round(u64 (&s)[T], int rnd) {
#pragma unroll
    for (int i = 0; i < T; ++i) s[i] = gl_sbox7(gl_add(s[i], c_round_constants[rnd * T + i]));
    mds_layer(s);
}

__device__ __forceinline__ void partial_round(u64 (&s)[T], int rnd) {
#pragma unroll
    for (int i = 0; i < T; ++i) s[i] = gl_add(s[i], c_round_constants[rnd * T + i]);
    s[0] = gl_sbox7(s[0]);
    mds_layer(s);
}

__device__ __forceinline__ void permute_state(u64 (&s)[T]) {
#pragma unroll 1
    for (int rnd = 0; rnd < HALF_FULL; ++rnd) full_round(s, rnd);
#pragma unroll 1
    for (int rnd = HALF_FULL; rnd < HALF_FULL + N_PARTIAL; ++rnd) partial_round(s, rnd);
#pragma unroll 1
    for (int rnd = HALF_FULL + N_PARTIAL; rnd < N_ROUNDS; ++rnd) full_round(s, rnd);
}

// states [B, 12] contiguous -> out [B, 12] contiguous.
__global__ void __launch_bounds__(THREADS)
permute_kernel(const u64* __restrict__ in, u64* __restrict__ out, long long B) {
    long long stride = (long long)gridDim.x * blockDim.x;
    for (long long row = (long long)blockIdx.x * blockDim.x + threadIdx.x; row < B; row += stride) {
        u64 s[T];
#pragma unroll
        for (int i = 0; i < T; ++i) s[i] = in[row * T + i];
        permute_state(s);
#pragma unroll
        for (int i = 0; i < T; ++i) out[row * T + i] = s[i];
    }
}

// inputs [B, width] with element (row, col) at in[row * row_stride + col *
// col_stride] -> out [B, 4] contiguous.  Zero state, overwrite-absorb in
// rate-8 chunks, one permutation per chunk, all in registers.  With
// row_stride == 1 (a transposed [width, B] matrix) neighbouring threads read
// neighbouring addresses.
__global__ void __launch_bounds__(THREADS)
hash_no_pad_kernel(const u64* __restrict__ in, long long row_stride, long long col_stride,
                   int width, u64* __restrict__ out, long long B) {
    long long stride = (long long)gridDim.x * blockDim.x;
    for (long long row = (long long)blockIdx.x * blockDim.x + threadIdx.x; row < B; row += stride) {
        const u64* src = in + row * row_stride;
        u64 s[T];
#pragma unroll
        for (int i = 0; i < T; ++i) s[i] = 0;
        for (int start = 0; start < width; start += RATE) {
#pragma unroll
            for (int j = 0; j < RATE; ++j) {
                if (start + j < width) s[j] = src[(long long)(start + j) * col_stride];
            }
            permute_state(s);
        }
#pragma unroll
        for (int i = 0; i < 4; ++i) out[row * 4 + i] = s[i];
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

// Upload the constants (host arrays: 360 round constants, 12 circulant
// entries, the one non-zero diagonal entry).  Called once after loading.
int poseidon_set_constants(const u64* round_constants, const u64* mds_circ, u64 mds_diag0) {
    cudaError_t err = cudaMemcpyToSymbol(c_round_constants, round_constants, sizeof(u64) * N_ROUNDS * T);
    if (err != cudaSuccess) return (int)err;
    unsigned int circ[T];
    for (int i = 0; i < T; ++i) circ[i] = (unsigned int)mds_circ[i];
    unsigned int diag0 = (unsigned int)mds_diag0;
    err = cudaMemcpyToSymbol(c_mds_circ, circ, sizeof(circ));
    if (err != cudaSuccess) return (int)err;
    err = cudaMemcpyToSymbol(c_mds_diag0, &diag0, sizeof(diag0));
    return (int)err;
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

const char* poseidon_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

}  // extern "C"
