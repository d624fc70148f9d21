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

__device__ __forceinline__ u64 gl_neg(u64 a) { return a == 0 ? a : GL_P - a; }

// a * c for a constant c < 2^20 (mirrors ops/goldilocks.py::mul_small): two
// 32x32 partial products, recombined to a (top, low) pair and reduced once.
__device__ __forceinline__ u64 gl_mul_small(u64 a, u64 c) {
    u64 lo_part = (a & GL_EPSILON) * c;  // < 2^52
    u64 hi_part = (a >> 32) * c;         // < 2^52
    u64 low = lo_part + (hi_part << 32);
    u64 top = (hi_part >> 32) + (low < lo_part ? 1ULL : 0ULL);
    return gl_reduce128(top, low);
}

// x^(2^n) by n squarings; the loop is kept rolled: the chain is sequential
// anyway and the Fermat inverse below is inlined into several kernels.
__device__ __forceinline__ u64 gl_sqn(u64 x, int n) {
#pragma unroll 1
    for (int i = 0; i < n; ++i) x = gl_mul(x, x);
    return x;
}

// x^-1 = x^(p-2), 0 -> 0.  p - 2 = 2^64 - 2^32 - 1 is 31 ones, a zero, then
// 32 ones, so the chain builds c_k = x^(2^k - 1) by doubling
// (c_2k = c_k^(2^k) * c_k): 64 squarings and 10 multiplies, against the 63
// squarings and 62 multiplies of the plain version's square-and-multiply
// (ops/goldilocks.py::inv).  The chains differ and the values do not: every
// gl_mul returns the canonical product.
__device__ __forceinline__ u64 gl_inv(u64 x) {
    u64 c1 = x;
    u64 c2 = gl_mul(gl_sqn(c1, 1), c1);
    u64 c4 = gl_mul(gl_sqn(c2, 2), c2);
    u64 c8 = gl_mul(gl_sqn(c4, 4), c4);
    u64 c16 = gl_mul(gl_sqn(c8, 8), c8);
    u64 c24 = gl_mul(gl_sqn(c16, 8), c8);
    u64 c28 = gl_mul(gl_sqn(c24, 4), c4);
    u64 c30 = gl_mul(gl_sqn(c28, 2), c2);
    u64 c31 = gl_mul(gl_sqn(c30, 1), c1);
    u64 c32 = gl_mul(gl_sqn(c31, 1), c1);  // x^(2^32 - 1)
    // p - 2 = (2^31 - 1) * 2^33 + (2^32 - 1)
    return gl_mul(gl_sqn(c31, 33), c32);
}
