// Goldilocks field arithmetic (p = 2^64 - 2^32 + 1) on native 64-bit
// registers: the shared device header under every kernel of the port.
//
// It takes the place of the JAX package's ops/limb64.py, which carries each
// u64 as two u32 planes because its target has no 64-bit integer unit.  The
// GPU multiplies 64x64 directly (mul.lo.u64 + mul.hi.u64), so nothing of the
// limb layout is reproduced: only the values are.  Every function mirrors
// the formula of the plain PyTorch version (ops/goldilocks.py) step by step,
// so the two agree bit for bit on every u64 input, canonical or not.
#pragma once

typedef unsigned long long u64;

#define GL_P 0xFFFFFFFF00000001ULL
#define GL_EPSILON 0xFFFFFFFFULL  // 2^64 mod p

__device__ __forceinline__ u64 gl_add(u64 a, u64 b) {
    u64 s = a + b;
    if (s < a) s += GL_EPSILON;  // wrapped: 2^64 = EPSILON (mod p)
    if (s >= GL_P) s -= GL_P;
    return s;
}

__device__ __forceinline__ u64 gl_sub(u64 a, u64 b) {
    u64 d = a - b;
    if (a < b) d -= GL_EPSILON;  // borrow: -2^64 = -EPSILON (mod p)
    return d;
}

// (hi * 2^64 + lo) mod p, with 2^64 = 2^32 - 1 and 2^96 = -1 (mod p):
//   x = lo + hi_lo * (2^32 - 1) - hi_hi
__device__ __forceinline__ u64 gl_reduce128(u64 hi, u64 lo) {
    u64 hi_hi = hi >> 32;
    u64 hi_lo = hi & GL_EPSILON;
    u64 t0 = lo - hi_hi;
    if (lo < hi_hi) t0 -= GL_EPSILON;
    u64 t1 = hi_lo * GL_EPSILON;  // < 2^64, no overflow
    u64 t2 = t0 + t1;
    if (t2 < t0) t2 += GL_EPSILON;
    if (t2 >= GL_P) t2 -= GL_P;
    return t2;
}

__device__ __forceinline__ u64 gl_mul(u64 a, u64 b) {
    return gl_reduce128(__umul64hi(a, b), a * b);
}

// x^7: four multiplies (x2, x3, x6, x7).
__device__ __forceinline__ u64 gl_sbox7(u64 x) {
    u64 x2 = gl_mul(x, x);
    u64 x3 = gl_mul(x2, x);
    u64 x6 = gl_mul(x3, x3);
    return gl_mul(x6, x);
}
