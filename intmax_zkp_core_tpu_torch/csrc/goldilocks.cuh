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

// ---------------------------------------------------------------------------
// Loose arithmetic for the hot loops of poseidon.cu, ntt.cu,
// gate_quotient.cu, perm_columns.cu and perm_quotient.cu.  A loose value is
// any u64 and stands for its residue mod p: it may lie in [p, 2^64).  The
// functions below take loose inputs, return loose results and never compute
// a general 64x64 multiply for a reduction; gl_canon makes a loose value
// canonical once, at the end.  Carries are read from the carry flag, never
// from a compare.  Each inline-PTX sequence sits alone in one small
// function.  The functions above stay as they are: they mirror the
// plain PyTorch version formula by formula and the other kernels use them.
// Where a function's bound needs a canonical operand, its comment says so.
// ---------------------------------------------------------------------------

typedef unsigned int u32;

// (hi, lo) = a * b from four 32x32 partial products with carry chains.
__device__ __forceinline__ void gl_mul128(u64 a, u64 b, u64& hi, u64& lo) {
    asm("{\n\t"
        ".reg .u32 a0, a1, b0, b1, r0, r1, r2, r3;\n\t"
        "mov.b64 {a0, a1}, %2;\n\t"
        "mov.b64 {b0, b1}, %3;\n\t"
        "mul.lo.u32 r0, a0, b0;\n\t"
        "mul.hi.u32 r1, a0, b0;\n\t"
        "mul.lo.u32 r2, a1, b1;\n\t"
        "mul.hi.u32 r3, a1, b1;\n\t"
        "mad.lo.cc.u32 r1, a0, b1, r1;\n\t"
        "madc.hi.cc.u32 r2, a0, b1, r2;\n\t"
        "addc.u32 r3, r3, 0;\n\t"
        "mad.lo.cc.u32 r1, a1, b0, r1;\n\t"
        "madc.hi.cc.u32 r2, a1, b0, r2;\n\t"
        "addc.u32 r3, r3, 0;\n\t"
        "mov.b64 %0, {r2, r3};\n\t"
        "mov.b64 %1, {r0, r1};\n\t"
        "}"
        : "=l"(hi), "=l"(lo)
        : "l"(a), "l"(b));
}

// (hi, lo) = a * a from three partial products: the cross product once,
// doubled by a shift.
__device__ __forceinline__ void gl_sqr128(u64 a, u64& hi, u64& lo) {
    asm("{\n\t"
        ".reg .u32 a0, a1, r0, r1, r2, r3, c0, c1, c2;\n\t"
        "mov.b64 {a0, a1}, %2;\n\t"
        "mul.lo.u32 r0, a0, a0;\n\t"
        "mul.hi.u32 r1, a0, a0;\n\t"
        "mul.lo.u32 r2, a1, a1;\n\t"
        "mul.hi.u32 r3, a1, a1;\n\t"
        "mul.lo.u32 c0, a0, a1;\n\t"
        "mul.hi.u32 c1, a0, a1;\n\t"
        "shr.b32 c2, c1, 31;\n\t"
        "shf.l.wrap.b32 c1, c0, c1, 1;\n\t"
        "shl.b32 c0, c0, 1;\n\t"
        "add.cc.u32 r1, r1, c0;\n\t"
        "addc.cc.u32 r2, r2, c1;\n\t"
        "addc.u32 r3, r3, c2;\n\t"
        "mov.b64 %0, {r2, r3};\n\t"
        "mov.b64 %1, {r0, r1};\n\t"
        "}"
        : "=l"(hi), "=l"(lo)
        : "l"(a));
}

// (hi, lo) = a * b + c; below 2^128 for every u64 a, b, c.
__device__ __forceinline__ void gl_mul_add128(u64 a, u64 b, u64 c, u64& hi, u64& lo) {
    asm("{\n\t"
        ".reg .u32 a0, a1, b0, b1, c0, c1, r0, r1, r2, r3;\n\t"
        "mov.b64 {a0, a1}, %2;\n\t"
        "mov.b64 {b0, b1}, %3;\n\t"
        "mov.b64 {c0, c1}, %4;\n\t"
        "mul.lo.u32 r2, a1, b1;\n\t"
        "mul.hi.u32 r3, a1, b1;\n\t"
        "mad.lo.cc.u32 r0, a0, b0, c0;\n\t"
        "madc.hi.cc.u32 r1, a0, b0, c1;\n\t"
        "addc.cc.u32 r2, r2, 0;\n\t"
        "addc.u32 r3, r3, 0;\n\t"
        "mad.lo.cc.u32 r1, a0, b1, r1;\n\t"
        "madc.hi.cc.u32 r2, a0, b1, r2;\n\t"
        "addc.u32 r3, r3, 0;\n\t"
        "mad.lo.cc.u32 r1, a1, b0, r1;\n\t"
        "madc.hi.cc.u32 r2, a1, b0, r2;\n\t"
        "addc.u32 r3, r3, 0;\n\t"
        "mov.b64 %0, {r2, r3};\n\t"
        "mov.b64 %1, {r0, r1};\n\t"
        "}"
        : "=l"(hi), "=l"(lo)
        : "l"(a), "l"(b), "l"(c));
}

// A sum of up to 2^31 products a * b, kept unreduced: the products' diagonal
// parts a0 b0 + a1 b1 2^64 in d (four words and a carry word dt) and their
// cross parts a0 b1 + a1 b0 in x (two words and a carry word xt), so that
// each product costs one carry chain of each kind.  `hi_lo` combines them
// into the 160-bit value (dt, hi, lo).
struct GlDot {
    u32 d0 = 0, d1 = 0, d2 = 0, d3 = 0, dt = 0, x0 = 0, x1 = 0, xt = 0;

    __device__ __forceinline__ void mac(u64 a, u64 b) {
        asm("{\n\t"
            ".reg .u32 a0, a1, b0, b1;\n\t"
            "mov.b64 {a0, a1}, %8;\n\t"
            "mov.b64 {b0, b1}, %9;\n\t"
            "mad.lo.cc.u32 %0, a0, b0, %0;\n\t"
            "madc.hi.cc.u32 %1, a0, b0, %1;\n\t"
            "madc.lo.cc.u32 %2, a1, b1, %2;\n\t"
            "madc.hi.cc.u32 %3, a1, b1, %3;\n\t"
            "addc.u32 %4, %4, 0;\n\t"
            "mad.lo.cc.u32 %5, a0, b1, %5;\n\t"
            "madc.hi.cc.u32 %6, a0, b1, %6;\n\t"
            "addc.u32 %7, %7, 0;\n\t"
            "mad.lo.cc.u32 %5, a1, b0, %5;\n\t"
            "madc.hi.cc.u32 %6, a1, b0, %6;\n\t"
            "addc.u32 %7, %7, 0;\n\t"
            "}"
            : "+r"(d0), "+r"(d1), "+r"(d2), "+r"(d3), "+r"(dt), "+r"(x0), "+r"(x1), "+r"(xt)
            : "l"(a), "l"(b));
    }

    // The sum as top * 2^128 + hi * 2^64 + lo (top at most the number of
    // products plus one).
    __device__ __forceinline__ void hi_lo(u32& top, u64& hi, u64& lo) const {
        asm("{\n\t"
            ".reg .u32 r1, r2, r3;\n\t"
            "add.cc.u32 r1, %4, %8;\n\t"
            "addc.cc.u32 r2, %5, %9;\n\t"
            "addc.cc.u32 r3, %6, %10;\n\t"
            "addc.u32 %0, %7, 0;\n\t"
            "mov.b64 %1, {r2, r3};\n\t"
            "mov.b64 %2, {%3, r1};\n\t"
            "}"
            : "=r"(top), "=l"(hi), "=l"(lo)
            : "r"(d0), "r"(d1), "r"(d2), "r"(d3), "r"(dt), "r"(x0), "r"(x1), "r"(xt));
    }
};

// hi * 2^64 + lo -> loose, with 2^64 = 2^32 - 1 and 2^96 = -1 (mod p):
// v = lo + hi_lo * 2^32 - hi_lo - hi_hi in one carry chain, whose multiple
// k of 2^64 (-1, 0 or 1) is folded back as k (2^32 - 1); that cannot wrap
// again.  No multiply, no compare.
__device__ __forceinline__ u64 gl_reduce128_loose(u64 hi, u64 lo) {
    u64 x;
    asm("{\n\t"
        ".reg .u32 l0, l1, h0, h1, r0, r1, s0, s1, k;\n\t"
        ".reg .s64 ks, t;\n\t"
        ".reg .u64 r;\n\t"
        "mov.b64 {l0, l1}, %1;\n\t"
        "mov.b64 {h0, h1}, %2;\n\t"
        "add.cc.u32 r1, l1, h0;\n\t"
        "addc.u32 k, 0, 0;\n\t"
        "add.cc.u32 s0, h0, h1;\n\t"
        "addc.u32 s1, 0, 0;\n\t"
        "sub.cc.u32 r0, l0, s0;\n\t"
        "subc.cc.u32 r1, r1, s1;\n\t"
        "subc.u32 k, k, 0;\n\t"
        "mov.b64 r, {r0, r1};\n\t"
        "cvt.s64.s32 ks, k;\n\t"
        "shl.b64 t, ks, 32;\n\t"
        "sub.s64 t, t, ks;\n\t"
        "add.u64 %0, r, t;\n\t"
        "}"
        : "=l"(x)
        : "l"(lo), "l"(hi));
    return x;
}

// top * 2^128 + hi * 2^64 + lo -> loose, with 2^128 = -2^32 (mod p), for
// top < 2^32: a borrow of the subtraction of top * 2^32 takes 2^32 - 1 off.
__device__ __forceinline__ u64 gl_reduce160_loose(u32 top, u64 hi, u64 lo) {
    u64 x = gl_reduce128_loose(hi, lo);
    asm("{\n\t"
        ".reg .u32 x0, x1, b;\n\t"
        "mov.b64 {x0, x1}, %0;\n\t"
        "sub.cc.u32 x1, x1, %1;\n\t"
        "subc.u32 b, 0, 0;\n\t"
        "sub.cc.u32 x0, x0, b;\n\t"
        "subc.u32 x1, x1, 0;\n\t"
        "mov.b64 %0, {x0, x1};\n\t"
        "}"
        : "+l"(x)
        : "r"(top));
    return x;
}

// A GlDot's sum reduced once, to a loose value.
__device__ __forceinline__ u64 gl_dot_reduce(const GlDot& d) {
    u32 top;
    u64 hi, lo;
    d.hi_lo(top, hi, lo);
    return gl_reduce160_loose(top, hi, lo);
}

// acc_lo + acc_hi * 2^32 + c -> loose, for acc_lo, acc_hi < 2^62 and any c:
// the 96-bit sum n2 * 2^64 + n, then n + n2 (2^32 - 1) with its carry k
// folded back as k (2^32 - 1).
__device__ __forceinline__ u64 gl_fold_reduce_loose(u64 acc_lo, u64 acc_hi, u64 c) {
    u64 x;
    asm("{\n\t"
        ".reg .u32 a0, a1, b0, b1, c0, c1, n0, n1, n2, k;\n\t"
        "mov.b64 {a0, a1}, %1;\n\t"
        "mov.b64 {b0, b1}, %2;\n\t"
        "mov.b64 {c0, c1}, %3;\n\t"
        "add.cc.u32 n0, a0, c0;\n\t"
        "addc.cc.u32 n1, a1, c1;\n\t"
        "addc.u32 n2, b1, 0;\n\t"
        "add.cc.u32 n1, n1, b0;\n\t"
        "addc.u32 n2, n2, 0;\n\t"
        "add.cc.u32 n1, n1, n2;\n\t"
        "addc.u32 k, 0, 0;\n\t"
        "sub.cc.u32 n0, n0, n2;\n\t"
        "subc.cc.u32 n1, n1, 0;\n\t"
        "subc.u32 k, k, 0;\n\t"
        "sub.u32 k, 0, k;\n\t"
        "add.cc.u32 n0, n0, k;\n\t"
        "addc.u32 n1, n1, 0;\n\t"
        "mov.b64 %0, {n0, n1};\n\t"
        "}"
        : "=l"(x)
        : "l"(acc_lo), "l"(acc_hi), "l"(c));
    return x;
}

// a + c for a loose a and a canonical c: a carry adds 2^32 - 1, which cannot
// wrap again.
__device__ __forceinline__ u64 gl_add_loose(u64 a, u64 c) {
    u64 x;
    asm("{\n\t"
        ".reg .u32 a0, a1, c0, c1, k;\n\t"
        "mov.b64 {a0, a1}, %1;\n\t"
        "mov.b64 {c0, c1}, %2;\n\t"
        "add.cc.u32 a0, a0, c0;\n\t"
        "addc.cc.u32 a1, a1, c1;\n\t"
        "addc.u32 k, 0, 0;\n\t"
        "sub.u32 k, 0, k;\n\t"
        "add.cc.u32 a0, a0, k;\n\t"
        "addc.u32 a1, a1, 0;\n\t"
        "mov.b64 %0, {a0, a1};\n\t"
        "}"
        : "=l"(x)
        : "l"(a), "l"(c));
    return x;
}

// a - c for a loose a and a canonical c: a borrow takes 2^32 - 1 off, which
// cannot borrow again (a - c + 2^64 >= 2^64 - c > 2^32 - 1).
__device__ __forceinline__ u64 gl_sub_loose(u64 a, u64 c) {
    u64 x;
    asm("{\n\t"
        ".reg .u32 a0, a1, c0, c1, k;\n\t"
        "mov.b64 {a0, a1}, %1;\n\t"
        "mov.b64 {c0, c1}, %2;\n\t"
        "sub.cc.u32 a0, a0, c0;\n\t"
        "subc.cc.u32 a1, a1, c1;\n\t"
        "subc.u32 k, 0, 0;\n\t"
        "sub.cc.u32 a0, a0, k;\n\t"
        "subc.u32 a1, a1, 0;\n\t"
        "mov.b64 %0, {a0, a1};\n\t"
        "}"
        : "=l"(x)
        : "l"(a), "l"(c));
    return x;
}

__device__ __forceinline__ u64 gl_mul_loose(u64 a, u64 b) {
    u64 hi, lo;
    gl_mul128(a, b, hi, lo);
    return gl_reduce128_loose(hi, lo);
}

__device__ __forceinline__ u64 gl_sqr_loose(u64 a) {
    u64 hi, lo;
    gl_sqr128(a, hi, lo);
    return gl_reduce128_loose(hi, lo);
}

// a * b + c -> loose, for any u64 a, b, c: one carry chain, one reduction.
__device__ __forceinline__ u64 gl_mul_add_loose(u64 a, u64 b, u64 c) {
    u64 hi, lo;
    gl_mul_add128(a, b, c, hi, lo);
    return gl_reduce128_loose(hi, lo);
}

// x^7 as two squarings and two multiplies.
__device__ __forceinline__ u64 gl_sbox7_loose(u64 x) {
    u64 x3 = gl_mul_loose(gl_sqr_loose(x), x);
    return gl_mul_loose(gl_sqr_loose(x3), x);
}

__device__ __forceinline__ u64 gl_canon(u64 x) { return x >= GL_P ? x - GL_P : x; }

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
