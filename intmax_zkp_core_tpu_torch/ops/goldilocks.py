"""Goldilocks field (p = 2^64 - 2^32 + 1) arithmetic on PyTorch tensors.

Representation
--------------
``torch.uint64`` has no arithmetic in PyTorch, so a field element travels as
the ``torch.int64`` tensor holding the same 64 bits (two's complement).  All
functions here read and write such bit patterns:

* wrapping ``+``, ``-``, ``*`` on int64 are the wrapping u64 operations;
* a logical right shift is an arithmetic shift followed by a mask;
* an unsigned compare is a signed compare after flipping the top bit;
* 64x64->128 products are built from four 32x32->64 partial products and
  reduced with ``2^64 = 2^32 - 1`` / ``2^96 = -1 (mod p)`` — no division.

Every function maps elementwise over arbitrary leading dimensions and accepts
a Python int (already wrapped with ``i64``) wherever a tensor broadcasts.
Values cross to and from numpy ``uint64`` with ``from_u64`` / ``to_u64``.

Same names and semantics as the JAX package's ``ops/goldilocks.py``; the
values are identical bit for bit.
"""

from __future__ import annotations

import numpy as np
import torch

P_INT = 0xFFFFFFFF00000001  # 2^64 - 2^32 + 1
_TWO64 = 1 << 64
_SIGN = -(1 << 63)  # top bit as an int64


def i64(c: int) -> int:
    """The Python int whose int64 two's-complement bits are the u64 ``c``."""
    c %= _TWO64
    return c - _TWO64 if c >= (1 << 63) else c


P = i64(P_INT)
EPSILON = 0xFFFFFFFF  # 2^64 mod p = 2^32 - 1
MASK32 = 0xFFFFFFFF

# Multiplicative group: order p-1 = 2^32 * 3 * 5 * 17 * 257 * 65537.
TWO_ADICITY = 32
# g = 7 generates the multiplicative group; used for LDE coset shifts.
MULTIPLICATIVE_GROUP_GENERATOR = 7


def resolve_device(device=None) -> torch.device:
    """``None`` means the CUDA device, and raises when there is none: no code
    path looks for a GPU and quietly carries on without one."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device available; pass device='cpu' explicitly to run on the host"
            )
        return torch.device("cuda")
    return torch.device(device)


def from_u64(a, device) -> torch.Tensor:
    """numpy uint64 (or anything numpy can make one of) -> int64 bit patterns
    on ``device``."""
    arr = np.ascontiguousarray(np.asarray(a, dtype=np.uint64))
    return torch.from_numpy(arr.view(np.int64)).to(torch.device(device))


def as_field(x, device=None) -> torch.Tensor:
    """Entry-point argument -> int64 bit patterns.  A tensor carries its own
    device (moved only when ``device`` is given); host data (numpy uint64,
    lists of ints) is uploaded to ``resolve_device(device)``."""
    if isinstance(x, torch.Tensor):
        if x.dtype != torch.int64:
            raise TypeError(f"field tensors are int64 bit patterns, got {x.dtype}")
        return x if device is None else x.to(torch.device(device))
    return from_u64(x, resolve_device(device))


def to_u64(t: torch.Tensor) -> np.ndarray:
    """int64 bit patterns -> numpy uint64 on the host."""
    return t.detach().cpu().contiguous().numpy().view(np.uint64)


def _ult(a, b):
    """Unsigned a < b on int64 bit patterns."""
    return (a ^ _SIGN) < (b ^ _SIGN)


def _lsr32(a):
    """Logical shift right by 32."""
    return (a >> 32) & MASK32


def canonicalize(x: torch.Tensor) -> torch.Tensor:
    """Map any u64 into canonical [0, p)."""
    return torch.where(_ult(x, P), x, x - P)


def add(a, b):
    """(a + b) mod p for canonical inputs."""
    s = a + b
    # wrapped iff s < a; 2^64 = EPSILON (mod p)
    s = torch.where(_ult(s, a), s + EPSILON, s)
    return torch.where(_ult(s, P), s, s - P)


def sub(a, b):
    """(a - b) mod p for canonical inputs."""
    d = a - b
    # borrow iff a < b; -2^64 = -EPSILON (mod p)
    return torch.where(_ult(a, b), d - EPSILON, d)


def neg(a):
    return torch.where(a == 0, a, P - a)


def _mul_128(a, b):
    """Full 64x64 -> 128-bit product as (hi, lo) u64 bit patterns."""
    a_lo = a & MASK32
    a_hi = _lsr32(a)
    b_lo = b & MASK32
    b_hi = _lsr32(b)
    ll = a_lo * b_lo
    lh = a_lo * b_hi
    hl = a_hi * b_lo
    hh = a_hi * b_hi
    # mid = lh + hl, tracking the single possible carry into bit 64
    mid = lh + hl
    mid_carry = _ult(mid, lh).to(torch.int64)
    lo = ll + (mid << 32)
    lo_carry = _ult(lo, ll).to(torch.int64)
    hi = hh + _lsr32(mid) + (mid_carry << 32) + lo_carry
    return hi, lo


def reduce128(hi, lo):
    """Reduce a 128-bit value (hi*2^64 + lo) mod p.

    Uses 2^64 = 2^32 - 1 and 2^96 = -1 (mod p):
      x = lo + hi_lo*(2^32 - 1) - hi_hi   (mod p)
    """
    hi_hi = _lsr32(hi)
    hi_lo = hi & MASK32
    t0 = lo - hi_hi
    t0 = torch.where(_ult(lo, hi_hi), t0 - EPSILON, t0)
    t1 = hi_lo * EPSILON  # < 2^64, no overflow
    t2 = t0 + t1
    t2 = torch.where(_ult(t2, t0), t2 + EPSILON, t2)
    return torch.where(_ult(t2, P), t2, t2 - P)


def mul(a, b):
    """(a * b) mod p for canonical inputs."""
    hi, lo = _mul_128(a, b)
    return reduce128(hi, lo)


def square(a):
    return mul(a, a)


def pow_const(a, e: int):
    """a^e for a Python-int exponent (unrolled square-and-multiply)."""
    if e == 0:
        return torch.ones_like(a)
    result = None
    base = a
    while e:
        if e & 1:
            result = base if result is None else mul(result, base)
        e >>= 1
        if e:
            base = square(base)
    return result


def inv(a):
    """a^-1 = a^(p-2); a=0 maps to 0 (callers guard)."""
    return pow_const(a, P_INT - 2)


def mul_small(a, c: int):
    """a * c for a small (< 2^20) Python-int constant, cheaper than mul()."""
    lo_part = (a & MASK32) * c  # < 2^52
    hi_part = _lsr32(a) * c  # < 2^52
    # value = lo_part + hi_part * 2^32  (< 2^85) -> (hi, lo) pair
    s = lo_part + (hi_part << 32)
    carry = _ult(s, lo_part).to(torch.int64)
    hi = _lsr32(hi_part) + carry
    return reduce128(hi, s)


def powers(base: int, n: int, device) -> torch.Tensor:
    """[1, base, base^2, ..., base^(n-1)] as an [n] tensor, built by doubling
    (log2(n) batched multiplies instead of an n-step host loop)."""
    base %= P_INT
    out = torch.ones(1, dtype=torch.int64, device=torch.device(device))
    step = base
    while out.shape[0] < n:
        out = torch.cat([out, mul(out, i64(step))])
        step = step * step % P_INT
    return out[:n].contiguous()


# ---------------------------------------------------------------------------
# Python-int scalar helpers (host-side witness generation / tests)
# ---------------------------------------------------------------------------


def add_s(a: int, b: int) -> int:
    return (a + b) % P_INT


def sub_s(a: int, b: int) -> int:
    return (a - b) % P_INT


def mul_s(a: int, b: int) -> int:
    return (a * b) % P_INT


def inv_s(a: int) -> int:
    return pow(a, P_INT - 2, P_INT)


def exp_power_of_2_s(a: int, k: int) -> int:
    for _ in range(k):
        a = (a * a) % P_INT
    return a


def primitive_root_of_unity(n_log: int) -> int:
    """2^n_log-th primitive root of unity, derived g^((p-1) / 2^n_log)."""
    assert 0 <= n_log <= TWO_ADICITY
    base = pow(MULTIPLICATIVE_GROUP_GENERATOR, (P_INT - 1) >> TWO_ADICITY, P_INT)
    return exp_power_of_2_s(base, TWO_ADICITY - n_log)


# ---------------------------------------------------------------------------
# Quadratic extension F_{p^2} = F_p[x] / (x^2 - W),  W = 7.
# Elements are (..., 2) tensors: c0 + c1*x.
# ---------------------------------------------------------------------------

W_EXT = 7


def ext_add(a, b):
    return add(a, b)


def ext_sub(a, b):
    return sub(a, b)


def ext_mul(a, b):
    """(a0 + a1 x)(b0 + b1 x) = a0 b0 + W a1 b1 + (a0 b1 + a1 b0) x."""
    a0, a1 = a[..., 0], a[..., 1]
    b0, b1 = b[..., 0], b[..., 1]
    c0 = add(mul(a0, b0), mul_small(mul(a1, b1), W_EXT))
    c1 = add(mul(a0, b1), mul(a1, b0))
    return torch.stack([c0, c1], dim=-1)


def ext_square(a):
    return ext_mul(a, a)


def ext_neg(a):
    return neg(a)


def ext_scalar_mul(a, s):
    return mul(a, s[..., None])


def ext_from_base(a):
    return torch.stack([a, torch.zeros_like(a)], dim=-1)


def ext_pow_const(a, e: int):
    if e == 0:
        out = torch.zeros_like(a)
        out[..., 0] = 1
        return out
    result = None
    base = a
    while e:
        if e & 1:
            result = base if result is None else ext_mul(result, base)
        e >>= 1
        if e:
            base = ext_square(base)
    return result


def ext_inv(a):
    """(a0 + a1 x)^-1 = (a0 - a1 x) / (a0^2 - W a1^2)."""
    a0, a1 = a[..., 0], a[..., 1]
    norm = sub(square(a0), mul_small(square(a1), W_EXT))
    n_inv = inv(norm)
    return torch.stack([mul(a0, n_inv), neg(mul(a1, n_inv))], dim=-1)
