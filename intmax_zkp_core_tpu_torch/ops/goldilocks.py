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

from ..engine import spans

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
    """int64 bit patterns -> numpy uint64 on the host.  The prover's one
    device -> host crossing: it waits for the work queued before it, and
    while a recorder is active it is the span ``prover:fetch``, counted in
    ``fetches`` and ``fetch_s`` (``engine/spans.py``)."""
    with spans.fetch():
        return t.detach().cpu().contiguous().numpy().view(np.uint64)


def _ult(a, b):
    """Unsigned a < b on int64 bit patterns."""
    return (a ^ _SIGN) < (b ^ _SIGN)


def _lsr32(a):
    """Logical shift right by 32."""
    s = a >> 32
    return s.bitwise_and_(MASK32) if isinstance(s, torch.Tensor) else s & MASK32


_P_FLIPPED = P ^ _SIGN

# The functions below build each result from as few elementwise passes and
# fresh tensors as they can: a carry or borrow is the 0/1 of an in-place
# compare (``lt_`` / ``gt_`` on a temporary of the result's shape) folded in
# with ``add_(..., alpha=+-EPSILON)``, not a ``torch.where``, which is
# several times slower on the CPU.  In-place operations only ever write
# temporaries of the broadcast result's shape, never an argument.


def _wrapped(s, a):
    """0/1: the sum s = a + b wrapped past 2^64 (s <u a); ``s`` has the
    broadcast shape."""
    return (s ^ _SIGN).lt_(a ^ _SIGN)


def _borrowed(d, a):
    """0/1: the difference d = a - b wrapped below 0 (d >u a); ``d`` has the
    broadcast shape."""
    return (d ^ _SIGN).gt_(a ^ _SIGN)


def _canonicalize_(x: torch.Tensor) -> torch.Tensor:
    """``canonicalize`` in place, on a temporary."""
    # x - p = x + EPSILON (mod 2^64)
    return x.add_((x ^ _SIGN).ge_(_P_FLIPPED), alpha=EPSILON)


def canonicalize(x: torch.Tensor) -> torch.Tensor:
    """Map any u64 into canonical [0, p)."""
    return _canonicalize_(x.clone())


def add(a, b):
    """(a + b) mod p for canonical inputs."""
    s = a + b
    # 2^64 = EPSILON (mod p)
    return _canonicalize_(s.add_(_wrapped(s, a), alpha=EPSILON))


def sub(a, b):
    """(a - b) mod p for canonical inputs."""
    d = a - b
    # -2^64 = -EPSILON (mod p)
    return d.add_(_borrowed(d, a), alpha=-EPSILON)


def neg(a):
    return torch.where(a == 0, a, P - a)


def _mul_128(a, b):
    """Full 64x64 -> 128-bit product as (hi, lo) u64 bit patterns."""
    a_lo, a_hi = a & MASK32, _lsr32(a)
    b_lo, b_hi = b & MASK32, _lsr32(b)
    ll = a_lo * b_lo
    lh = a_lo * b_hi
    hl = a_hi * b_lo
    hh = a_hi * b_hi
    # the middle column, with the carry out of the low word: < 3 * 2^32
    t = _lsr32(ll).add_(lh & MASK32).add_(hl & MASK32)
    lo = ll.bitwise_and_(MASK32).bitwise_or_(t << 32)
    hi = hh.add_(_lsr32(lh)).add_(_lsr32(hl)).add_(t.bitwise_right_shift_(32))
    return hi, lo


def _square_128(a):
    """``_mul_128(a, a)`` with the two cross products taken once."""
    a_lo, a_hi = a & MASK32, _lsr32(a)
    ll = a_lo * a_lo
    lh = a_lo * a_hi
    hh = a_hi.mul_(a_hi)
    t = _lsr32(ll).add_((lh & MASK32).bitwise_left_shift_(1))  # < 3 * 2^32
    lo = ll.bitwise_and_(MASK32).bitwise_or_(t << 32)
    hi = hh.add_(_lsr32(lh).bitwise_left_shift_(1)).add_(t.bitwise_right_shift_(32))
    return hi, lo


def reduce128(hi, lo):
    """Reduce a 128-bit value (hi*2^64 + lo) mod p.

    Uses 2^64 = 2^32 - 1 and 2^96 = -1 (mod p):
      x = lo + hi_lo*(2^32 - 1) - hi_hi   (mod p)
    """
    hi_hi = _lsr32(hi)
    t0 = lo - hi_hi
    t0.add_(_borrowed(t0, lo), alpha=-EPSILON)
    t2 = torch.add(t0, hi & MASK32, alpha=EPSILON)  # hi_lo * EPSILON < 2^64
    return _canonicalize_(t2.add_(_wrapped(t2, t0), alpha=EPSILON))


def mul(a, b):
    """(a * b) mod p for any u64 inputs (canonical output)."""
    hi, lo = _mul_128(a, b)
    return reduce128(hi, lo)


def square(a):
    return reduce128(*_square_128(a))


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
    hi = _lsr32(hi_part).add_(_wrapped(s, lo_part))
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
