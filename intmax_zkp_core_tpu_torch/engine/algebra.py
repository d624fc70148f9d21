"""Algebra shim so gate-constraint evaluators are written once and run in
two modes:

* ``BatchAlgebra`` — vectorized base-field evaluation over the whole LDE
  coset (the prover's quotient computation; int64 bit-pattern tensors);
* ``ExtAlgebra`` — exact scalar evaluation at a single extension-field
  point (the verifier's constraint check at zeta; Python ints).

This is the trick that keeps the constraint definitions single-sourced: the
same ``Gate.eval_constraints`` drives both the hot batched kernel and the
verifier.
"""

from __future__ import annotations

from ..ops import goldilocks as gl

P = gl.P_INT


class BatchAlgebra:
    """Values are int64 bit-pattern tensors (broadcastable) or wrapped
    Python-int constants; base field."""

    def const(self, c: int):
        return gl.i64(c % P)

    def add(self, a, b):
        return gl.add(a, b)

    def sub(self, a, b):
        return gl.sub(a, b)

    def mul(self, a, b):
        return gl.mul(a, b)

    def add_const(self, a, c: int):
        return gl.add(a, gl.i64(c % P))

    def mul_const(self, a, c: int):
        c = c % P
        if c == 0:
            return 0
        if c == 1:
            return a
        if c < (1 << 20):
            return gl.mul_small(a, c)
        return gl.mul(a, gl.i64(c))

    def exp7(self, a):
        a2 = gl.square(a)
        a3 = gl.mul(a2, a)
        return gl.mul(gl.square(a3), a)


class ExtAlgebra:
    """Values are (c0, c1) int tuples in F_p[x]/(x^2 - 7)."""

    def const(self, c: int):
        return (c % P, 0)

    def add(self, a, b):
        return ((a[0] + b[0]) % P, (a[1] + b[1]) % P)

    def sub(self, a, b):
        return ((a[0] - b[0]) % P, (a[1] - b[1]) % P)

    def mul(self, a, b):
        return (
            (a[0] * b[0] + 7 * a[1] * b[1]) % P,
            (a[0] * b[1] + a[1] * b[0]) % P,
        )

    def add_const(self, a, c: int):
        return ((a[0] + c) % P, a[1])

    def mul_const(self, a, c: int):
        return (a[0] * c % P, a[1] * c % P)

    def exp7(self, a):
        a2 = self.mul(a, a)
        a3 = self.mul(a2, a)
        return self.mul(self.mul(a3, a3), a)


# scalar ext helpers shared by prover/verifier host code

def ext_add(a, b):
    return ((a[0] + b[0]) % P, (a[1] + b[1]) % P)


def ext_sub(a, b):
    return ((a[0] - b[0]) % P, (a[1] - b[1]) % P)


def ext_mul(a, b):
    return ((a[0] * b[0] + 7 * a[1] * b[1]) % P, (a[0] * b[1] + a[1] * b[0]) % P)


def ext_inv(a):
    norm = (a[0] * a[0] - 7 * a[1] * a[1]) % P
    ninv = pow(norm, P - 2, P)
    return (a[0] * ninv % P, (-a[1]) * ninv % P)


def ext_pow(a, e: int):
    result = (1, 0)
    base = a
    while e:
        if e & 1:
            result = ext_mul(result, base)
        e >>= 1
        base = ext_mul(base, base)
    return result
