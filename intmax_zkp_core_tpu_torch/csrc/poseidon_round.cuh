// The MDS rows of Poseidon-12 over Goldilocks and its constants, shared by
// the kernels that evaluate the permutation: poseidon.cu (the permutation and
// the sponge) and gate_quotient.cu (the Poseidon gate's constraints) each
// run their own loose rounds over mds_row.
//
// The constants are `static __constant__`: each source that includes this
// header has its own copy in its own module and fills what it reads through
// poseidon_round_upload (round constants and MDS) or
// poseidon_mds_upload (MDS alone), called from that source's
// *_set_constants entry.
// Every thread of a warp reads the same entry, which the constant cache
// broadcasts.
//
// mds_row computes the plain PyTorch version's MDS layer (ops/poseidon.py:
// _mds_layer) row by row on 32-bit limbs, before any reduction.
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

// Fill this module's copy of the 360 round constants and the MDS entries.
static int poseidon_round_upload(const u64* round_constants, const u64* mds_circ, u64 mds_diag0) {
    cudaError_t err = cudaMemcpyToSymbol(c_round_constants, round_constants, sizeof(u64) * N_ROUNDS * T);
    if (err != cudaSuccess) return (int)err;
    return poseidon_mds_upload(mds_circ, mds_diag0);
}
