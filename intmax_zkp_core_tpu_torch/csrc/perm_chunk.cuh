// The chunk of the permutation argument, shared by perm_columns.cu and
// perm_quotient.cu: the routed wires go in chunks of CHUNK (keeping the
// constraint degree at 8; ops/perm_quotient_cuda.py::CHUNK), the last one
// possibly shorter.
#pragma once

#include "goldilocks.cuh"

#define CHUNK 7

// The product of fac(0) .. fac(m - 1), m <= CHUNK, loose, left to right as
// the plain versions multiply (a tree of depth 3 ran slower in K5: it holds
// more values at once; PERF.md).
template <class Fac>
__device__ __forceinline__ u64 chunk_product(int m, Fac fac) {
    u64 p = fac(0);
#pragma unroll
    for (int i = 1; i < CHUNK; ++i)
        if (i < m) p = gl_mul_loose(p, fac(i));
    return p;
}
