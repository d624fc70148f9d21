"""Non-native secp256k1 arithmetic gadgets for in-circuit ECDSA.

The reference's ECDSA feature (cargo feature ``ecdsa``, off by default —
``Cargo.toml:12,19``) gets these from its plonky2_ecdsa dependency
(``src/ecdsa/bin/ecdsa_verification.rs:9-21`` imports
``CircuitBuilderNonNative`` / ``CircuitBuilderCurve`` /
``verify_message_circuit``).  This module is their counterpart, layered on
the engine's ``U32MulAddGate``:

* ``BigUintTarget`` — a 256-bit value as 8 little-endian u32 limb targets;
* exact-integer congruence checks: every modular claim ``x op y ≡ r (mod
  m)`` is proven as the integer identity ``x op y = q*m + r`` by forming
  both sides' base-2^32 columns from range-checked 32-bit partial products
  and normalizing with carry chains (all column sums stay < 2^38, far
  below the Goldilocks modulus, so no field wraparound);
* affine curve ops (``curve_add_nonequal``, ``curve_double``) with the
  slope as an inverse witness, matching plonky2_ecdsa's "nonequal add"
  contract: additions assume the operands have distinct x coordinates
  (guaranteed w.h.p. for honest witnesses by the random-offset trick in
  the scalar multipliers);
* scalar multiplication: 4-bit windowed with per-window offset points —
  a constant-base form (tables precomputed on the host; used for the
  generator and for constant public keys, as in the reference demo where
  ``builder.constant_affine_point(pk)`` is used) and a variable-base
  double-and-add form for ``AffinePointTarget`` keys.
"""

from __future__ import annotations

from dataclasses import dataclass

from ...engine.circuit import BoolTarget, CircuitBuilder
from ...engine.generators import register_generator_kind
from .account import GX, GY, N256, P256, _point_add, point_mul

N_LIMBS = 8
U32 = 1 << 32


def limbs_of(value: int, n_limbs: int = N_LIMBS) -> list[int]:
    assert 0 <= value < 1 << (32 * n_limbs)
    return [(value >> (32 * i)) & 0xFFFFFFFF for i in range(n_limbs)]


@dataclass(frozen=True)
class BigUintTarget:
    """A 256-bit unsigned value as 8 LE u32 limb targets (each < 2^32)."""

    limbs: tuple

    def __iter__(self):
        return iter(self.limbs)


@dataclass(frozen=True)
class AffinePointTarget:
    x: BigUintTarget
    y: BigUintTarget


def constant_biguint(builder: CircuitBuilder, value: int) -> BigUintTarget:
    return BigUintTarget(tuple(builder.constant(l) for l in limbs_of(value)))


def constant_affine_point(builder: CircuitBuilder, point) -> AffinePointTarget:
    """plonky2_ecdsa ``builder.constant_affine_point`` equivalent."""
    return AffinePointTarget(
        constant_biguint(builder, point[0]), constant_biguint(builder, point[1])
    )


def add_virtual_biguint(builder: CircuitBuilder, range_check: bool = True) -> BigUintTarget:
    ts = builder.add_virtual_targets(N_LIMBS)
    if range_check:
        for t in ts:
            builder.range_check_u32(t)
    return BigUintTarget(tuple(ts))


def set_biguint_witness(pw, big: BigUintTarget, value: int) -> None:
    for t, l in zip(big.limbs, limbs_of(value)):
        pw.set_target(t, l)


def _read_biguint(w, big: BigUintTarget):
    vals = [w.get(t) for t in big.limbs]
    if any(v is None for v in vals):
        return None
    return sum(v << (32 * i) for i, v in enumerate(vals))


# named compute functions for the biguint witness generator — declarative
# records (engine/generators.py) must reference computations by name
_BIGUINT_COMPUTES = {
    "mulmod": lambda m, x, y: (x * y) % m,
    "addmod": lambda m, x, y: (x + y) % m,
    "submod": lambda m, x, y: (x - y) % m,
    "invmod": lambda m, x: pow(x, -1, m),
    "slope_add": lambda m, x1, y1, x2, y2: (y2 - y1) * pow((x2 - x1) % m, -1, m) % m,
    "slope_double": lambda m, x, y: (3 * x * x) * pow(2 * y % m, -1, m) % m,
}


def _gen_biguint_compute(w, compute_name, modulus, input_limbs, output_limbs):
    vals = [_read_limbs(w, limbs) for limbs in input_limbs]
    if any(v is None for v in vals):
        return False
    results = _BIGUINT_COMPUTES[compute_name](modulus, *vals)
    if len(output_limbs) == 1:
        results = (results,)
    for limbs, res in zip(output_limbs, results):
        for i, t in enumerate(limbs):
            w.set(t, (res >> (32 * i)) & 0xFFFFFFFF)
    return True


def _read_limbs(w, limbs):
    vals = [w.get(t) for t in limbs]
    if any(v is None for v in vals):
        return None
    return sum(v << (32 * i) for i, v in enumerate(vals))


def _gen_mul_quotient(w, x_limbs, y_limbs, out_limbs, q_limbs, modulus):
    xv = _read_limbs(w, x_limbs)
    yv = _read_limbs(w, y_limbs)
    ov = _read_limbs(w, out_limbs)
    if xv is None or yv is None or ov is None:
        return False
    q = (xv * yv - ov) // modulus
    assert 0 <= q < 1 << (32 * (N_LIMBS + 1)), "quotient out of range"
    assert xv * yv == q * modulus + ov, "mul_nonnative witness mismatch"
    for i, t in enumerate(q_limbs):
        w.set(t, (q >> (32 * i)) & 0xFFFFFFFF)
    return True


def _gen_overflow_count(w, plus_limbs, minus_limbs, ov, modulus, ov_bound):
    pv = [_read_limbs(w, limbs) for limbs in plus_limbs]
    rv = [_read_limbs(w, limbs) for limbs in minus_limbs]
    if any(v is None for v in pv + rv):
        return False
    diff = sum(pv) - sum(rv)
    assert diff % modulus == 0, "addsub witness mismatch"
    k = diff // modulus
    assert 0 <= k < ov_bound, f"overflow count {k} out of range"
    w.set(ov, k)
    return True


register_generator_kind("ecdsa_biguint", _gen_biguint_compute)
register_generator_kind("ecdsa_mul_quotient", _gen_mul_quotient)
register_generator_kind("ecdsa_overflow_count", _gen_overflow_count)


def _witness_biguint(builder: CircuitBuilder, compute_name: str, modulus: int,
                     inputs: list[BigUintTarget], n_out: int = 1) -> list[BigUintTarget]:
    """Allocate ``n_out`` range-checked biguints whose limbs are generated
    from the integer values of ``inputs`` via the named compute function."""
    outs = [add_virtual_biguint(builder) for _ in range(n_out)]
    builder.generators.append((
        "ecdsa_biguint",
        compute_name,
        modulus,
        tuple(b.limbs for b in inputs),
        tuple(o.limbs for o in outs),
    ))
    return outs


# ---------------------------------------------------------------------------
# column accounting: prove integer identities between sums of 32-bit terms
# ---------------------------------------------------------------------------


def _normalize_columns(builder: CircuitBuilder, cols: list[list[int]]):
    """Carry-normalize base-2^32 columns into (limbs, final_carry).

    Every entry is < 2^32 (range-checked upstream) and every column has at
    most ~17 entries, so each running sum is < 2^38 < p: the u32 split is
    the exact integer division by 2^32 and the result is the unique
    base-2^32 form of the represented integer."""
    limbs = []
    carry = builder.zero()
    for col in cols:
        s = builder.add_many([carry] + col)
        lo, hi = builder.u32_split(s)
        limbs.append(lo)
        carry = hi
    return limbs, carry


def _connect_columns(builder: CircuitBuilder, lhs: list[list[int]], rhs: list[list[int]]):
    """Enforce that two column representations denote the same integer."""
    assert len(lhs) == len(rhs)
    ll, lc = _normalize_columns(builder, lhs)
    rl, rc = _normalize_columns(builder, rhs)
    for a, b in zip(ll, rl):
        builder.connect(a, b)
    builder.connect(lc, rc)


def _product_columns(builder: CircuitBuilder, x: BigUintTarget, y: BigUintTarget):
    """Base-2^32 columns of the 512-bit integer product x*y from 64
    range-checked 32x32 partial products."""
    zero = builder.zero()
    cols: list[list[int]] = [[] for _ in range(2 * N_LIMBS)]
    for i in range(N_LIMBS):
        for k in range(N_LIMBS):
            lo, hi = builder.u32_mul_add(x.limbs[i], y.limbs[k], zero)
            cols[i + k].append(lo)
            cols[i + k + 1].append(hi)
    return cols


def mul_nonnative_into(builder: CircuitBuilder, x: BigUintTarget, y: BigUintTarget,
                       out: BigUintTarget, modulus: int) -> None:
    """Constrain x * y ≡ out (mod modulus) via the integer identity
    x*y = q*modulus + out with a range-checked witness quotient q:
    x, y < 2^256 and modulus > 2^255 (secp256k1 base field or scalar
    order) give q = (x*y - out)/modulus < 2^512/2^255 = 2^257, so the
    quotient carries one extra limb (9 total)."""
    q_limbs = builder.add_virtual_targets(N_LIMBS + 1)
    for t in q_limbs:
        builder.range_check_u32(t)
    builder.generators.append((
        "ecdsa_mul_quotient", x.limbs, y.limbs, out.limbs, tuple(q_limbs), modulus
    ))

    lhs = _product_columns(builder, x, y)
    # rhs columns: q * modulus + out
    zero = builder.zero()
    m_limbs = limbs_of(modulus)
    rhs: list[list[int]] = [[] for _ in range(2 * N_LIMBS)]
    for i in range(N_LIMBS + 1):
        for k in range(N_LIMBS):
            if m_limbs[k] == 0:
                continue
            lo, hi = builder.u32_mul_add(q_limbs[i], builder.constant(m_limbs[k]), zero)
            if i + k < 2 * N_LIMBS:
                rhs[i + k].append(lo)
            else:
                builder.assert_zero(lo)
            if i + k + 1 < 2 * N_LIMBS:
                rhs[i + k + 1].append(hi)
            else:
                builder.assert_zero(hi)
    for j in range(N_LIMBS):
        rhs[j].append(out.limbs[j])
    _connect_columns(builder, lhs, rhs)


def mul_nonnative(builder: CircuitBuilder, x: BigUintTarget, y: BigUintTarget,
                  modulus: int) -> BigUintTarget:
    """r = x * y mod modulus (canonical witness; constraints prove the
    congruence and r < 2^256)."""
    (r,) = _witness_biguint(builder, "mulmod", modulus, [x, y], n_out=1)
    mul_nonnative_into(builder, x, y, r, modulus)
    return r


def _small_mul_columns(builder: CircuitBuilder, scale: int, value: int):
    """Columns of scale * value where scale is a small target (< 4) and
    value is a Python constant: per limb one arithmetic product < 2^34."""
    cols: list[list[int]] = [[] for _ in range(N_LIMBS + 1)]
    for k, l in enumerate(limbs_of(value)):
        if l:
            cols[k].append(builder.mul_const(l, scale))
    return cols


def _addsub_check(builder: CircuitBuilder, plus: list, minus_rhs: list,
                  modulus: int, ov_bound: int = 3):
    """Constrain sum(plus) = sum(minus_rhs) + ov*modulus with a small
    witness overflow count ov in [0, ov_bound); returns nothing.  Each
    argument is a list of BigUintTargets summed limb-wise."""
    ov = builder.add_virtual_target()
    builder.generators.append((
        "ecdsa_overflow_count",
        tuple(b.limbs for b in plus),
        tuple(b.limbs for b in minus_rhs),
        ov,
        modulus,
        ov_bound,
    ))
    # ov in [0, ov_bound): prod over (ov - k) == 0
    prod = None
    for k in range(ov_bound):
        term = builder.arithmetic(1, 1, ov, builder.one(), builder.constant((-k) % 0xFFFFFFFF00000001))
        prod = term if prod is None else builder.mul(prod, term)
    builder.assert_zero(prod)

    lhs: list[list[int]] = [[] for _ in range(N_LIMBS + 1)]
    rhs: list[list[int]] = [[] for _ in range(N_LIMBS + 1)]
    for b in plus:
        for j, l in enumerate(b.limbs):
            lhs[j].append(l)
    for b in minus_rhs:
        for j, l in enumerate(b.limbs):
            rhs[j].append(l)
    for j, col in enumerate(_small_mul_columns(builder, ov, modulus)):
        rhs[j].extend(col)
    _connect_columns(builder, lhs, rhs)


def add_nonnative(builder: CircuitBuilder, x: BigUintTarget, y: BigUintTarget,
                  modulus: int) -> BigUintTarget:
    """r = x + y mod modulus."""
    (r,) = _witness_biguint(builder, "addmod", modulus, [x, y])
    _addsub_check(builder, plus=[x, y], minus_rhs=[r], modulus=modulus, ov_bound=3)
    return r


def sub_nonnative(builder: CircuitBuilder, x: BigUintTarget, y: BigUintTarget,
                  modulus: int) -> BigUintTarget:
    """r = x - y mod modulus."""
    (r,) = _witness_biguint(builder, "submod", modulus, [x, y])
    # x + ov*m = y + r: same overflow-count witness with sides swapped
    ov = builder.add_virtual_target()
    builder.generators.append((
        "ecdsa_overflow_count",
        (y.limbs, r.limbs),
        (x.limbs,),
        ov,
        modulus,
        3,
    ))
    prod = None
    for k in range(3):
        term = builder.arithmetic(1, 1, ov, builder.one(),
                                  builder.constant((-k) % 0xFFFFFFFF00000001))
        prod = term if prod is None else builder.mul(prod, term)
    builder.assert_zero(prod)

    lhs: list[list[int]] = [[] for _ in range(N_LIMBS + 1)]
    rhs: list[list[int]] = [[] for _ in range(N_LIMBS + 1)]
    for j in range(N_LIMBS):
        lhs[j].append(x.limbs[j])
        rhs[j].append(y.limbs[j])
        rhs[j].append(r.limbs[j])
    for j, col in enumerate(_small_mul_columns(builder, ov, modulus)):
        lhs[j].extend(col)
    _connect_columns(builder, lhs, rhs)
    return r


def inv_nonnative(builder: CircuitBuilder, x: BigUintTarget, modulus: int) -> BigUintTarget:
    """r = x^-1 mod modulus (witnessed; constrained by x*r ≡ 1)."""
    (r,) = _witness_biguint(builder, "invmod", modulus, [x])
    one = constant_biguint(builder, 1)
    mul_nonnative_into(builder, x, r, one, modulus)
    return r


def select_biguint(builder: CircuitBuilder, flag: BoolTarget, x: BigUintTarget,
                   y: BigUintTarget) -> BigUintTarget:
    return BigUintTarget(tuple(
        builder.select(flag, a, b) for a, b in zip(x.limbs, y.limbs)
    ))


def select_point(builder: CircuitBuilder, flag: BoolTarget, p: AffinePointTarget,
                 q: AffinePointTarget) -> AffinePointTarget:
    return AffinePointTarget(
        select_biguint(builder, flag, p.x, q.x),
        select_biguint(builder, flag, p.y, q.y),
    )


# ---------------------------------------------------------------------------
# curve arithmetic (secp256k1: y^2 = x^3 + 7 over F_{P256})
# ---------------------------------------------------------------------------


def curve_add_nonequal(builder: CircuitBuilder, p1: AffinePointTarget,
                       p2: AffinePointTarget) -> AffinePointTarget:
    """Affine addition assuming x1 != x2 (plonky2_ecdsa's ``curve_add``
    contract): slope witness lam with lam*(x2-x1) ≡ y2-y1, then
    x3 = lam^2 - x1 - x2, y3 = lam*(x1-x3) - y1."""
    (lam,) = _witness_biguint(
        builder, "slope_add", P256, [p1.x, p1.y, p2.x, p2.y]
    )
    dx = sub_nonnative(builder, p2.x, p1.x, P256)
    dy = sub_nonnative(builder, p2.y, p1.y, P256)
    mul_nonnative_into(builder, lam, dx, dy, P256)
    lam2 = mul_nonnative(builder, lam, lam, P256)
    x3 = sub_nonnative(builder, sub_nonnative(builder, lam2, p1.x, P256), p2.x, P256)
    t = sub_nonnative(builder, p1.x, x3, P256)
    lam_t = mul_nonnative(builder, lam, t, P256)
    y3 = sub_nonnative(builder, lam_t, p1.y, P256)
    return AffinePointTarget(x3, y3)


def curve_double(builder: CircuitBuilder, p: AffinePointTarget) -> AffinePointTarget:
    """Affine doubling (y != 0 on secp256k1 — no 2-torsion): slope witness
    lam with lam*(2y) ≡ 3x^2, then x3 = lam^2 - 2x, y3 = lam*(x-x3) - y."""
    (lam,) = _witness_biguint(builder, "slope_double", P256, [p.x, p.y])
    x2 = mul_nonnative(builder, p.x, p.x, P256)
    three_x2 = add_nonnative(builder, add_nonnative(builder, x2, x2, P256), x2, P256)
    two_y = add_nonnative(builder, p.y, p.y, P256)
    mul_nonnative_into(builder, lam, two_y, three_x2, P256)
    lam2 = mul_nonnative(builder, lam, lam, P256)
    x3 = sub_nonnative(builder, sub_nonnative(builder, lam2, p.x, P256), p.x, P256)
    t = sub_nonnative(builder, p.x, x3, P256)
    lam_t = mul_nonnative(builder, lam, t, P256)
    y3 = sub_nonnative(builder, lam_t, p.y, P256)
    return AffinePointTarget(x3, y3)


# deterministic offset scalars for the windowed multipliers (public
# constants; they only serve to keep intermediate sums off infinity /
# equal-x pairs for honest witnesses, the same role as plonky2_ecdsa's
# "rando" starting point)
_OFFSET_SEED = 0x9E3779B97F4A7C15F39CC0605CEDC8341082276BF3A27251F86C6A11D0C18E95


def _offset_scalar(w: int) -> int:
    return pow(_OFFSET_SEED, w + 1, N256)


def _select_constant_point(builder: CircuitBuilder, bits: list[BoolTarget],
                           points: list[tuple]) -> AffinePointTarget:
    """16-way select of a constant affine point by 4 bits (LE)."""
    assert len(points) == 16 and len(bits) == 4
    one = builder.one()
    # indicator for each d: product over bits
    inds = []
    for d in range(16):
        acc = None
        for i, b in enumerate(bits):
            f = b.target if (d >> i) & 1 else builder.sub(one, b.target)
            acc = f if acc is None else builder.mul(acc, f)
        inds.append(acc)
    limbs = []
    for coord in range(2):
        for j in range(N_LIMBS):
            acc = builder.zero()
            for d in range(16):
                c = limbs_of(points[d][coord])[j]
                if c:
                    acc = builder.mul_const_add(c, inds[d], acc)
            limbs.append(acc)
    return AffinePointTarget(
        BigUintTarget(tuple(limbs[:N_LIMBS])), BigUintTarget(tuple(limbs[N_LIMBS:]))
    )


def biguint_bits(builder: CircuitBuilder, x: BigUintTarget) -> list[BoolTarget]:
    """LE bit decomposition of all limbs (256 bits)."""
    bits: list[BoolTarget] = []
    for l in x.limbs:
        bits.extend(builder.split_le(l, 32))
    return bits


def curve_scalar_mul_constant_base(builder: CircuitBuilder, base,
                                   scalar: BigUintTarget,
                                   n_bits: int = 32 * N_LIMBS,
                                   bits: list[BoolTarget] | None = None
                                   ) -> AffinePointTarget:
    """scalar * base for a constant affine point ``base`` via 4-bit
    windowed table lookups: window w's table holds
    ``d * 2^(4w) * base + O_w`` for d in 0..15 with deterministic offset
    points O_w, so no entry is the point at infinity and honest
    accumulations stay on distinct x w.h.p.; the summed offset is
    subtracted at the end.  ``n_bits`` can be lowered (multiple of 4) for
    cheap tests."""
    assert n_bits % 4 == 0
    n_windows = n_bits // 4
    if bits is None:
        bits = biguint_bits(builder, scalar)[:n_bits]
    assert len(bits) >= n_bits

    acc = None
    offset_sum = 0
    for w in range(n_windows):
        step = point_mul(pow(2, 4 * w, N256), base)
        s_w = _offset_scalar(w)
        offset_sum = (offset_sum + s_w) % N256
        o_w = point_mul(s_w)
        table = []
        mult = None
        for d in range(16):
            entry = _point_add(mult, o_w)
            assert entry is not None, "offset table hit infinity"
            table.append(entry)
            mult = _point_add(mult, step)
        sel = _select_constant_point(builder, bits[4 * w : 4 * w + 4], table)
        acc = sel if acc is None else curve_add_nonequal(builder, acc, sel)
    # subtract the accumulated offset: add -offset_sum * G ... the offsets
    # are multiples of G, NOT of `base`; O_w = _offset_scalar(w) * G.
    neg_off = point_mul((N256 - offset_sum) % N256)
    acc = curve_add_nonequal(builder, acc, constant_affine_point(builder, neg_off))
    return acc


def curve_scalar_mul(builder: CircuitBuilder, p: AffinePointTarget,
                     scalar: BigUintTarget, n_bits: int = 32 * N_LIMBS
                     ) -> AffinePointTarget:
    """scalar * p for a variable point: MSB-first double-and-add starting
    from a constant offset point R, with R * 2^n_bits subtracted at the
    end (plonky2_ecdsa's random-initial-point trick to dodge infinity)."""
    bits = biguint_bits(builder, scalar)[:n_bits]
    r_scalar = _offset_scalar(12345)
    acc = constant_affine_point(builder, point_mul(r_scalar))
    for bit in reversed(bits):
        acc = curve_double(builder, acc)
        added = curve_add_nonequal(builder, acc, p)
        acc = select_point(builder, bit, added, acc)
    correction = point_mul(
        (N256 - r_scalar * pow(2, n_bits, N256)) % N256
    )
    acc = curve_add_nonequal(builder, acc, constant_affine_point(builder, correction))
    return acc
