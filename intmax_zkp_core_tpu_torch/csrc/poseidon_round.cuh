// The full round of Poseidon-12 over Goldilocks and its constants, shared by
// the kernels that evaluate the permutation: gate_quotient.cu (the Poseidon
// gate's constraints) takes the full round; poseidon.cu (the permutation and
// the sponge) takes the MDS rows and constants under its own loose rounds.
//
// The constants are `static __constant__`: each source that includes this
// header has its own copy in its own module and fills what it reads through
// poseidon_round_upload (full_round: round constants and MDS) or
// poseidon_mds_upload (mds_row alone), called from that source's
// *_set_constants entry.
// Every thread of a warp reads the same entry, which the constant cache
// broadcasts.
//
// The arithmetic mirrors the plain PyTorch version (ops/poseidon.py:
// _sbox, _mds_layer) formula by formula.
#pragma once

#include <cuda_runtime.h>

#include "goldilocks.cuh"

#define T 12
#define N_ROUNDS 30
#define HALF_FULL 4
#define N_PARTIAL 22

static __constant__ u64 c_round_constants[N_ROUNDS * T];
static __constant__ unsigned int c_mds_circ[T];  // entries < 2^6: 32x32->64 multiply-adds suffice
static __constant__ unsigned int c_mds_diag0;

// Row r of the MDS product on the 32-bit limbs of the state:
// acc = sum_i CIRC[i] * limb[(r + i) % 12]  (+ DIAG[0] * limb[0] on lane 0),
// each accumulator below 264 * 2^32 < 2^41 (the entries sum to 264).
__device__ __forceinline__ void mds_row(const unsigned int (&lo)[T], const unsigned int (&hi)[T],
                                        int r, u64& acc_lo, u64& acc_hi) {
    acc_lo = 0;
    acc_hi = 0;
#pragma unroll
    for (int i = 0; i < T; ++i) {
        acc_lo += (u64)c_mds_circ[i] * lo[(r + i) % T];
        acc_hi += (u64)c_mds_circ[i] * hi[(r + i) % T];
    }
    if (r == 0) {
        acc_lo += (u64)c_mds_diag0 * lo[0];
        acc_hi += (u64)c_mds_diag0 * hi[0];
    }
}

// out[r] = sum_i CIRC[i] * s[(r + i) % 12]  (+ DIAG[0] * s[0] on lane 0),
// accumulated per 32-bit limb, recombined to a (top, low) pair and reduced
// once per lane.
__device__ __forceinline__ void mds_layer(u64 (&s)[T]) {
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
        u64 low = acc_lo + (acc_hi << 32);
        u64 top = (acc_hi >> 32) + (low < acc_lo ? 1ULL : 0ULL);
        s[r] = gl_reduce128(top, low);
    }
}

// s <- MDS * sbox(s + rc[rnd]) on all twelve lanes.
__device__ __forceinline__ void full_round(u64 (&s)[T], int rnd) {
#pragma unroll
    for (int i = 0; i < T; ++i) s[i] = gl_sbox7(gl_add(s[i], c_round_constants[rnd * T + i]));
    mds_layer(s);
}

// Fill this module's copy of the MDS entries (host arrays: 12 circulant
// entries, the one non-zero diagonal entry).
static int poseidon_mds_upload(const u64* mds_circ, u64 mds_diag0) {
    unsigned int circ[T];
    for (int i = 0; i < T; ++i) circ[i] = (unsigned int)mds_circ[i];
    unsigned int diag0 = (unsigned int)mds_diag0;
    cudaError_t err = cudaMemcpyToSymbol(c_mds_circ, circ, sizeof(circ));
    if (err != cudaSuccess) return (int)err;
    err = cudaMemcpyToSymbol(c_mds_diag0, &diag0, sizeof(diag0));
    return (int)err;
}

// Fill this module's copy of the constants full_round reads: the 360 round
// constants and the MDS entries.
static int poseidon_round_upload(const u64* round_constants, const u64* mds_circ, u64 mds_diag0) {
    cudaError_t err = cudaMemcpyToSymbol(c_round_constants, round_constants, sizeof(u64) * N_ROUNDS * T);
    if (err != cudaSuccess) return (int)err;
    return poseidon_mds_upload(mds_circ, mds_diag0);
}
