"""Goldilocks arithmetic and its quadratic extension F_p[x] / (x^2 - 7), in
Python integers (elements of the extension are (c0, c1) pairs)."""

from __future__ import annotations

P = 0xFFFFFFFF00000001
W = 7
TWO_ADICITY = 32
GENERATOR = 7  # generates the multiplicative group; the LDE coset shift


def root_of_unity(log_n: int) -> int:
    """A primitive 2^log_n-th root of unity: g^((p - 1) / 2^log_n)."""
    base = pow(GENERATOR, (P - 1) >> TWO_ADICITY, P)
    return pow(base, 1 << (TWO_ADICITY - log_n), P)


def inv(a: int) -> int:
    return pow(a, P - 2, P)


def add(a, b):
    return ((a[0] + b[0]) % P, (a[1] + b[1]) % P)


def sub(a, b):
    return ((a[0] - b[0]) % P, (a[1] - b[1]) % P)


def mul(a, b):
    return ((a[0] * b[0] + W * a[1] * b[1]) % P, (a[0] * b[1] + a[1] * b[0]) % P)


def scale(a, c: int):
    return (a[0] * c % P, a[1] * c % P)


def ext_inv(a):
    norm = (a[0] * a[0] - W * a[1] * a[1]) % P
    n_inv = inv(norm)
    return (a[0] * n_inv % P, -a[1] * n_inv % P)


def ext_pow(a, e: int):
    out, base = (1, 0), a
    while e:
        if e & 1:
            out = mul(out, base)
        base = mul(base, base)
        e >>= 1
    return out
