"""In-circuit SMT inclusion/exclusion verifier — circomlib's
``smtverifier`` (reference
``src/sparse_merkle_tree/gadgets/verify/verify_smt.rs``)."""

from __future__ import annotations

from dataclasses import dataclass

from ....engine.circuit import BoolTarget, CircuitBuilder, HashOutTarget
from ....utils.hash_out import HashOut
from ..proofs import SparseMerkleInclusionProof
from .common import (
    calc_internal_hash,
    calc_leaf_hash,
    enforce_equal_if_enabled,
    is_equal_hash_out,
    logical_and_not,
    smt_lev_ins_t,
)


@dataclass
class VerifierLoopElt:
    top: BoolTarget
    i0: BoolTarget
    i_old: BoolTarget
    i_new: BoolTarget
    na: BoolTarget


def smt_verifier_sm(
    builder: CircuitBuilder,
    is0: BoolTarget,
    lev_ins: BoolTarget,
    fnc: BoolTarget,
    prev: VerifierLoopElt,
) -> VerifierLoopElt:
    """``verify_smt.rs:157-211``."""
    aux1 = BoolTarget(builder.mul(prev.top.target, lev_ins.target))
    aux2 = BoolTarget(builder.mul(aux1.target, fnc.target))
    top = BoolTarget(builder.sub(prev.top.target, aux1.target))
    i_new = BoolTarget(builder.sub(aux1.target, aux2.target))
    not_is0 = builder.sub(builder.one(), is0.target)
    i_old = BoolTarget(builder.mul(aux2.target, not_is0))
    i0 = BoolTarget(builder.mul(aux1.target, is0.target))
    na1 = builder.add(prev.na.target, prev.i_new.target)
    na2 = builder.add(na1, prev.i_old.target)
    na = BoolTarget(builder.add(na2, prev.i0.target))
    return VerifierLoopElt(top=top, i0=i0, i_old=i_old, i_new=i_new, na=na)


def smt_verifier_level(
    builder: CircuitBuilder,
    st: VerifierLoopElt,
    sibling: HashOutTarget,
    old1_leaf: HashOutTarget,
    new1_leaf: HashOutTarget,
    lr_bit: BoolTarget,
    child: HashOutTarget,
) -> HashOutTarget:
    """``verify_smt.rs:106-155``."""
    hash_out = calc_internal_hash(builder, child, sibling, lr_bit)
    root = []
    for a_i, b_i, c_i in zip(hash_out, old1_leaf, new1_leaf):
        sa = builder.mul(a_i, st.top.target)
        sb = builder.mul(b_i, st.i_old.target)
        sc = builder.mul(c_i, st.i_new.target)
        root.append(builder.add(builder.add(sa, sb), sc))
    return HashOutTarget(tuple(root))


def verify_smt_inclusion_proof_t(
    builder: CircuitBuilder,
    siblings: list[HashOutTarget],
    root: HashOutTarget,
    old_key: HashOutTarget,
    old_value: HashOutTarget,
    key: HashOutTarget,
    value: HashOutTarget,
    enabled: BoolTarget,
    is_old0: BoolTarget,
    fnc: BoolTarget,
) -> None:
    """``verify_smt.rs:214-307``; fnc=1 checks exclusion."""
    num_levels = len(siblings)

    hash1_old = calc_leaf_hash(builder, old_key, old_value)
    hash1_new = calc_leaf_hash(builder, key, value)

    n2b_new = [b for e in key for b in builder.split_le_canonical(e)]

    lev_ins = smt_lev_ins_t(builder, enabled, siblings)

    prev = VerifierLoopElt(
        top=enabled,
        i0=builder.constant_bool(False),
        i_old=builder.constant_bool(False),
        i_new=builder.constant_bool(False),
        na=builder.not_(enabled),
    )
    sm: list[VerifierLoopElt] = []
    for i in range(num_levels):
        st = smt_verifier_sm(builder, is_old0, lev_ins[i], fnc, prev)
        sm.append(st)
        prev = st

    flag = builder.add(sm[-1].na.target, sm[-1].i_old.target)
    flag = builder.add(flag, sm[-1].i_new.target)
    flag = builder.add(flag, sm[-1].i0.target)
    builder.assert_one(flag)

    child = builder.zero_hash()
    for i in reversed(range(num_levels)):
        child = smt_verifier_level(
            builder, sm[i], siblings[i], hash1_old, hash1_new, n2b_new[i], child
        )

    # exclusion with a different leaf must really differ in key
    are_keys_equal = is_equal_hash_out(builder, old_key, key)
    flag = logical_and_not(builder, fnc, is_old0)
    flag = builder.and_(flag, enabled)
    keys_ok = builder.and_(flag, are_keys_equal)
    builder.assert_zero(keys_ok.target)

    enforce_equal_if_enabled(builder, root, child, enabled)


@dataclass
class SparseMerkleInclusionProofTarget:
    """``verify_smt.rs:28-104``."""

    siblings: list[HashOutTarget]
    root: HashOutTarget
    old_key: HashOutTarget
    old_value: HashOutTarget
    key: HashOutTarget
    value: HashOutTarget
    enabled: BoolTarget
    is_old0: BoolTarget
    fnc: BoolTarget

    @classmethod
    def add_virtual_to(cls, builder: CircuitBuilder, n_levels: int):
        siblings = builder.add_virtual_hashes(n_levels)
        root = builder.add_virtual_hash()
        old_key = builder.add_virtual_hash()
        old_value = builder.add_virtual_hash()
        key = builder.add_virtual_hash()
        value = builder.add_virtual_hash()
        enabled = builder.add_virtual_bool_target_safe()
        is_old0 = builder.add_virtual_bool_target_safe()
        fnc = builder.add_virtual_bool_target_safe()
        verify_smt_inclusion_proof_t(
            builder, siblings, root, old_key, old_value, key, value, enabled, is_old0, fnc
        )
        return cls(
            siblings=siblings, root=root, old_key=old_key, old_value=old_value, key=key,
            value=value, enabled=enabled, is_old0=is_old0, fnc=fnc,
        )

    def set_witness(self, pw, witness: SparseMerkleInclusionProof, enabled: bool) -> None:
        assert len(witness.siblings) < len(self.siblings), "siblings are too long"
        for i in range(len(self.siblings)):
            sib = witness.siblings[i] if i < len(witness.siblings) else HashOut.ZERO
            pw.set_hash_target(self.siblings[i], sib)
        pw.set_hash_target(self.root, witness.root)
        pw.set_hash_target(self.old_key, witness.not_found_key)
        pw.set_hash_target(self.old_value, witness.not_found_value)
        pw.set_hash_target(self.key, witness.key)
        pw.set_hash_target(self.value, witness.value)
        pw.set_bool_target(self.enabled, enabled)
        pw.set_bool_target(self.is_old0, witness.is_old0)
        pw.set_bool_target(self.fnc, not witness.found)
