"""Shared in-circuit helpers for the SMT gadgets (reference
``src/sparse_merkle_tree/gadgets/common.rs``): leaf/internal hashing with
the 12-lane padded layout, conditional select/reverse on digests,
boolean algebra, hash equality, and the circomlib smtlevins gadget."""

from __future__ import annotations

from ....engine.circuit import BoolTarget, CircuitBuilder, HashOutTarget

P = 0xFFFFFFFF00000001


def poseidon_two_to_one(
    builder: CircuitBuilder, x: HashOutTarget, y: HashOutTarget
) -> HashOutTarget:
    """``poseidon/gadgets/mod.rs:9-22``."""
    return builder.hash_n_to_hash_no_pad(list(x) + list(y))


def calc_leaf_hash(
    builder: CircuitBuilder, key: HashOutTarget, value: HashOutTarget
) -> HashOutTarget:
    """12-input padded leaf hash, flags at positions 8, 9, 11
    (``common.rs:87-101``) — the in-circuit mirror of
    ``PoseidonHash::hash_pad(key || value || 1)``.  Note: 12 *sponge
    inputs*, i.e. two rate-8 absorptions, not one 12-lane state."""
    one = builder.one()
    zero = builder.zero()
    inputs = list(key) + list(value) + [one, one, zero, one]
    return builder.hash_n_to_hash_no_pad(inputs)


def conditionally_reverse(
    builder: CircuitBuilder, x: HashOutTarget, y: HashOutTarget, condition: BoolTarget
) -> tuple[HashOutTarget, HashOutTarget]:
    """if condition { (y, x) } else { (x, y) } (``common.rs:134-155``)."""
    left, right = [], []
    for x_i, y_i in zip(x, y):
        delta = builder.sub(y_i, x_i)
        new_x = builder.arithmetic(1, 1, delta, condition.target, x_i)
        new_y = builder.arithmetic(P - 1, 1, delta, condition.target, y_i)
        left.append(new_x)
        right.append(new_y)
    return HashOutTarget(tuple(left)), HashOutTarget(tuple(right))


def conditionally_select(
    builder: CircuitBuilder, x: HashOutTarget, y: HashOutTarget, condition: BoolTarget
) -> HashOutTarget:
    """if condition { x } else { y }"""
    return builder.select_hash(condition, x, y)


def calc_internal_hash(
    builder: CircuitBuilder,
    child: HashOutTarget,
    sibling: HashOutTarget,
    swap: BoolTarget,
) -> HashOutTarget:
    """H(swap ? (sibling, child) : (child, sibling)) — one Poseidon gate via
    the built-in swap wire (cheaper than the reference's explicit
    conditionally_reverse + hash)."""
    return builder.two_to_one_swapped(child, sibling, swap)


def element_wise_arithmetic(
    builder: CircuitBuilder, c0: int, c1: int, x: HashOutTarget, y: HashOutTarget,
    addend: HashOutTarget,
) -> HashOutTarget:
    """Per-limb c0*x*y + c1*addend (``common.rs:157-177``)."""
    return HashOutTarget(
        tuple(
            builder.arithmetic(c0, c1, xi, yi, ai)
            for xi, yi, ai in zip(x, y, addend)
        )
    )


def element_wise_add(
    builder: CircuitBuilder, x: HashOutTarget, y: HashOutTarget
) -> HashOutTarget:
    return HashOutTarget(tuple(builder.add(a, b) for a, b in zip(x, y)))


def element_wise_sub(
    builder: CircuitBuilder, x: HashOutTarget, y: HashOutTarget
) -> HashOutTarget:
    return HashOutTarget(tuple(builder.sub(a, b) for a, b in zip(x, y)))


def element_wise_mul(
    builder: CircuitBuilder, x: HashOutTarget, y: HashOutTarget
) -> HashOutTarget:
    return HashOutTarget(tuple(builder.mul(a, b) for a, b in zip(x, y)))


def logical_and_not(builder: CircuitBuilder, x: BoolTarget, y: BoolTarget) -> BoolTarget:
    """x AND NOT y = x - x*y (``common.rs:211-222``)."""
    t = builder.arithmetic(P - 1, 1, x.target, y.target, x.target)
    return BoolTarget(t)


def logical_or(builder: CircuitBuilder, x: BoolTarget, y: BoolTarget) -> BoolTarget:
    x_and_not_y = logical_and_not(builder, x, y)
    return BoolTarget(builder.add(x_and_not_y.target, y.target))


def logical_xor(builder: CircuitBuilder, x: BoolTarget, y: BoolTarget) -> BoolTarget:
    """x + y - 2xy (``common.rs:300-315``)."""
    tmp = builder.arithmetic(2, P - 1, x.target, y.target, y.target)
    return BoolTarget(builder.sub(x.target, tmp))


def logical_nor(builder: CircuitBuilder, x: BoolTarget, y: BoolTarget) -> BoolTarget:
    return logical_and_not(builder, builder.not_(x), y)


def material_implication(builder: CircuitBuilder, x: BoolTarget, y: BoolTarget) -> BoolTarget:
    return builder.not_(logical_and_not(builder, x, y))


def is_equal_hash_out(
    builder: CircuitBuilder, left: HashOutTarget, right: HashOutTarget
) -> BoolTarget:
    """``common.rs:318-330``."""
    out = builder.constant_bool(True)
    for l, r in zip(left, right):
        out = builder.and_(out, builder.is_equal(l, r))
    return out


def count(builder: CircuitBuilder, search: HashOutTarget, targets) -> int:
    counter = builder.zero()
    for t in targets:
        found = is_equal_hash_out(builder, search, t)
        counter = builder.add(counter, found.target)
    return counter


def enforce_equal_if_enabled(
    builder: CircuitBuilder, left: HashOutTarget, right: HashOutTarget, enabled: BoolTarget
) -> None:
    """``common.rs:345-357``."""
    eq = is_equal_hash_out(builder, left, right)
    a = logical_and_not(builder, enabled, eq)
    builder.assert_zero(a.target)


def enforce_not_equal_if_enabled(
    builder: CircuitBuilder, left: HashOutTarget, right: HashOutTarget, enabled: BoolTarget
) -> None:
    eq = is_equal_hash_out(builder, left, right)
    a = builder.and_(enabled, eq)
    builder.assert_zero(a.target)


def smt_lev_ins_t(
    builder: CircuitBuilder, enabled: BoolTarget, siblings: list[HashOutTarget]
) -> list[BoolTarget]:
    """In-circuit smtlevins (``common.rs:373-432``)."""
    num_levels = len(siblings)
    zero_hash = builder.zero_hash()
    is_zeros = [is_equal_hash_out(builder, s, zero_hash) for s in siblings]
    is_zeros.reverse()

    # last level (deepest sibling) must be zero when enabled
    bad = logical_and_not(builder, enabled, is_zeros[0])
    builder.assert_zero(bad.target)

    lev_ins = [builder.not_(is_zeros[1])]
    done = [lev_ins[0]]
    for i in range(1, num_levels - 1):
        last_done = done[-1]
        is_non_zero = builder.not_(is_zeros[i + 1])
        lev_ins.append(logical_and_not(builder, is_non_zero, last_done))
        done.append(BoolTarget(builder.add(lev_ins[-1].target, last_done.target)))
    lev_ins.append(builder.not_(done[-1]))
    lev_ins.reverse()
    return lev_ins
