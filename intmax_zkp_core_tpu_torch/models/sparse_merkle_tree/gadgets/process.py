"""In-circuit SMT process-proof verifier — circomlib's ``smtprocessor``
(reference ``src/sparse_merkle_tree/gadgets/process/process_smt.rs`` and
``process/utils.rs``)."""

from __future__ import annotations

from dataclasses import dataclass

from ....engine.circuit import BoolTarget, CircuitBuilder, HashOutTarget
from ....utils.hash_out import HashOut
from ..proofs import SparseMerkleProcessProof, first_different_bit_index
from .common import (
    calc_internal_hash,
    calc_leaf_hash,
    conditionally_reverse,
    conditionally_select,
    element_wise_add,
    enforce_equal_if_enabled,
    logical_and_not,
    logical_nor,
    logical_or,
    logical_xor,
    smt_lev_ins_t,
)


@dataclass
class ProcessMerkleProofRoleTarget:
    """11 derived role flags from fnc[2] (``process/utils.rs:27-56``)."""

    is_no_op: BoolTarget
    is_insert_op: BoolTarget
    is_update_op: BoolTarget
    is_remove_op: BoolTarget
    is_insert_or_update_op: BoolTarget
    is_remove_or_update_op: BoolTarget
    is_insert_or_no_op: BoolTarget
    is_remove_or_no_op: BoolTarget
    is_insert_or_remove_op: BoolTarget
    is_update_or_no_op: BoolTarget
    is_not_no_op: BoolTarget


def get_process_merkle_proof_role(
    builder: CircuitBuilder, fnc: tuple[BoolTarget, BoolTarget]
) -> ProcessMerkleProofRoleTarget:
    f0, f1 = fnc
    is_insert_or_update_op = logical_xor(builder, f0, f1)
    return ProcessMerkleProofRoleTarget(
        is_no_op=logical_nor(builder, f0, f1),
        is_insert_op=logical_and_not(builder, f0, f1),
        is_update_op=logical_and_not(builder, f1, f0),
        is_remove_op=builder.and_(f0, f1),
        is_insert_or_update_op=is_insert_or_update_op,
        is_remove_or_update_op=f1,
        is_insert_or_no_op=builder.not_(f1),
        is_remove_or_no_op=builder.not_(is_insert_or_update_op),
        is_insert_or_remove_op=f0,
        is_update_or_no_op=builder.not_(f0),
        is_not_no_op=logical_or(builder, f0, f1),
    )


def verify_smt_transition(
    builder: CircuitBuilder,
    cur_smt_fnc: tuple[BoolTarget, BoolTarget],
    prev_new_smt_root: HashOutTarget,
    cur_old_smt_root: HashOutTarget,
) -> None:
    """Root chaining across consecutive process proofs
    (``process/utils.rs:58-67``)."""
    is_not_no_op = logical_or(builder, cur_smt_fnc[0], cur_smt_fnc[1])
    enforce_equal_if_enabled(builder, prev_new_smt_root, cur_old_smt_root, is_not_no_op)


def verify_layered_smt_target_connection(
    builder: CircuitBuilder,
    upper_smt_fnc: tuple[BoolTarget, BoolTarget],
    old_upper_smt_value: HashOutTarget,
    new_upper_smt_value: HashOutTarget,
    old_lower_smt_root: HashOutTarget,
    new_lower_smt_root: HashOutTarget,
) -> None:
    """In-circuit layered connection rule (``process/utils.rs:69-117``)."""
    default_hash = builder.zero_hash()
    role = get_process_merkle_proof_role(builder, upper_smt_fnc)
    enforce_equal_if_enabled(
        builder, old_lower_smt_root, default_hash, role.is_insert_or_no_op
    )
    enforce_equal_if_enabled(
        builder, new_lower_smt_root, new_upper_smt_value, role.is_insert_or_update_op
    )
    enforce_equal_if_enabled(
        builder, new_lower_smt_root, default_hash, role.is_remove_or_no_op
    )
    enforce_equal_if_enabled(
        builder, old_lower_smt_root, old_upper_smt_value, role.is_remove_or_update_op
    )


@dataclass
class ProcessorLoopElt:
    top: BoolTarget
    old0: BoolTarget
    bot: BoolTarget
    new1: BoolTarget
    na: BoolTarget
    upd: BoolTarget


def smt_processor_sm(
    builder: CircuitBuilder,
    xor: BoolTarget,
    is0: BoolTarget,
    lev_ins: BoolTarget,
    is_insert_or_remove_op: BoolTarget,
    prev: ProcessorLoopElt,
) -> ProcessorLoopElt:
    """circomlib smtprocessorsm transition (``process_smt.rs:454-525``)."""
    aux1 = builder.and_(prev.top, lev_ins)
    aux2 = builder.and_(aux1, is_insert_or_remove_op)
    top = logical_and_not(builder, prev.top, lev_ins)
    old0 = builder.and_(aux2, is0)
    aux2_minus_old0 = logical_and_not(builder, aux2, is0)
    branch = logical_or(builder, aux2_minus_old0, prev.bot)
    new1 = builder.and_(branch, xor)
    bot = logical_and_not(builder, branch, xor)
    upd = logical_and_not(builder, aux1, is_insert_or_remove_op)
    na1 = logical_or(builder, prev.new1, prev.old0)
    na2 = logical_or(builder, na1, prev.na)
    na = logical_or(builder, na2, prev.upd)
    return ProcessorLoopElt(top=top, old0=old0, bot=bot, new1=new1, na=na, upd=upd)


def smt_processor_level(
    builder: CircuitBuilder,
    st: ProcessorLoopElt,
    sibling: HashOutTarget,
    old1_leaf: HashOutTarget,
    new1_leaf: HashOutTarget,
    new_lr_bit: BoolTarget,
    old_child: HashOutTarget,
    new_child: HashOutTarget,
) -> tuple[HashOutTarget, HashOutTarget]:
    """Per-level root reconstruction (``process_smt.rs:352-436``) — 2
    Poseidon gates per level, the engine's gate-count hot spot."""
    default_hash = builder.zero_hash()

    old_hash_out = calc_internal_hash(builder, old_child, sibling, new_lr_bit)

    st_bot_new1_upd = BoolTarget(
        builder.add(builder.add(st.bot.target, st.new1.target), st.upd.target)
    )
    aux0 = conditionally_select(builder, old1_leaf, default_hash, st_bot_new1_upd)
    a = conditionally_select(builder, old_hash_out, default_hash, st.top)
    old_root = element_wise_add(builder, a, aux0)

    st_top_or_bot = BoolTarget(builder.add(st.top.target, st.bot.target))
    aux1 = conditionally_select(builder, new_child, default_hash, st_top_or_bot)
    b = conditionally_select(builder, new1_leaf, default_hash, st.new1)
    new_left_child = element_wise_add(builder, b, aux1)

    aux2 = conditionally_select(builder, sibling, default_hash, st.top)
    c = conditionally_select(builder, old1_leaf, default_hash, st.new1)
    new_right_child = element_wise_add(builder, c, aux2)

    new_hash_out = calc_internal_hash(builder, new_left_child, new_right_child, new_lr_bit)

    st_top_bot_new1 = BoolTarget(builder.add(st_top_or_bot.target, st.new1.target))
    aux3 = conditionally_select(builder, new_hash_out, default_hash, st_top_bot_new1)
    st_old0_or_upd = BoolTarget(builder.add(st.old0.target, st.upd.target))
    d = conditionally_select(builder, new1_leaf, default_hash, st_old0_or_upd)
    new_root = element_wise_add(builder, d, aux3)

    return old_root, new_root


def verify_smt_process_proof_t(
    builder: CircuitBuilder,
    siblings: list[HashOutTarget],
    old_root: HashOutTarget,
    old_key: HashOutTarget,
    old_value: HashOutTarget,
    new_root: HashOutTarget,
    new_key: HashOutTarget,
    new_value: HashOutTarget,
    is_old0: BoolTarget,
    fnc: tuple[BoolTarget, BoolTarget],
) -> None:
    """Top-level process verification (``process_smt.rs:121-340``)."""
    constant_false = builder.constant_bool(False)
    num_levels = len(siblings)

    role = get_process_merkle_proof_role(builder, fnc)
    is_remove_op = role.is_remove_op

    # delete is verified as insert with old/new swapped (the circomlib trick,
    # process_smt.rs:145-153)
    fnc0 = fnc[0]
    fnc1 = BoolTarget(builder.select(is_remove_op, constant_false.target, fnc[1].target))
    fnc = (fnc0, fnc1)
    old_key, new_key = conditionally_reverse(builder, old_key, new_key, is_remove_op)
    old_value, new_value = conditionally_reverse(builder, old_value, new_value, is_remove_op)
    old_root, new_root = conditionally_reverse(builder, old_root, new_root, is_remove_op)

    role = get_process_merkle_proof_role(builder, fnc)
    enabled = role.is_not_no_op
    builder.assert_zero(role.is_remove_op.target)

    hash1_old = calc_leaf_hash(builder, old_key, old_value)
    hash1_new = calc_leaf_hash(builder, new_key, new_value)

    n2b_old = [b for e in old_key for b in builder.split_le_canonical(e)]
    n2b_new = [b for e in new_key for b in builder.split_le_canonical(e)]

    lev_ins = smt_lev_ins_t(builder, enabled, siblings)

    xors = [
        logical_xor(builder, a, b)
        for a, b in zip(n2b_old[:num_levels], n2b_new[:num_levels])
    ]

    prev = ProcessorLoopElt(
        top=enabled,
        old0=constant_false,
        new1=constant_false,
        bot=constant_false,
        na=builder.not_(enabled),
        upd=constant_false,
    )
    sm: list[ProcessorLoopElt] = []
    for i in range(num_levels):
        st = smt_processor_sm(
            builder, xors[i], is_old0, lev_ins[i], role.is_insert_or_remove_op, prev
        )
        sm.append(st)
        prev = st

    # final status must not be top/bottom
    tmp1 = logical_or(builder, sm[-1].na, sm[-1].new1)
    tmp2 = logical_or(builder, sm[-1].old0, sm[-1].upd)
    flag = logical_or(builder, tmp1, tmp2)
    builder.assert_one(flag.target)

    prev_level = (builder.zero_hash(), builder.zero_hash())
    for i in reversed(range(num_levels)):
        old_child, new_child = prev_level
        prev_level = smt_processor_level(
            builder, sm[i], siblings[i], hash1_old, hash1_new, n2b_new[i], old_child, new_child
        )

    top_l, top_r = prev_level
    enforce_equal_if_enabled(builder, top_l, old_root, enabled)
    enforce_equal_if_enabled(builder, top_r, new_root, enabled)

    enforce_equal_if_enabled(builder, old_key, new_key, role.is_update_or_no_op)
    enforce_equal_if_enabled(builder, old_root, new_root, role.is_no_op)
    enforce_equal_if_enabled(builder, old_value, new_value, role.is_no_op)


@dataclass
class SparseMerkleProcessProofTarget:
    """The reusable target bundle (``process_smt.rs:26-119``)."""

    siblings: list[HashOutTarget]
    old_root: HashOutTarget
    new_root: HashOutTarget
    old_key: HashOutTarget
    old_value: HashOutTarget
    new_key: HashOutTarget
    new_value: HashOutTarget
    is_old0: BoolTarget
    fnc: tuple[BoolTarget, BoolTarget]

    @classmethod
    def add_virtual_to(cls, builder: CircuitBuilder, n_levels: int):
        siblings = builder.add_virtual_hashes(n_levels)
        old_root = builder.add_virtual_hash()
        old_key = builder.add_virtual_hash()
        old_value = builder.add_virtual_hash()
        new_root = builder.add_virtual_hash()
        new_key = builder.add_virtual_hash()
        new_value = builder.add_virtual_hash()
        is_old0 = builder.add_virtual_bool_target_safe()
        fnc0 = builder.add_virtual_bool_target_safe()
        fnc1 = builder.add_virtual_bool_target_safe()
        verify_smt_process_proof_t(
            builder, siblings, old_root, old_key, old_value, new_root, new_key, new_value,
            is_old0, (fnc0, fnc1),
        )
        return cls(
            siblings=siblings, old_root=old_root, new_root=new_root, old_key=old_key,
            old_value=old_value, new_key=new_key, new_value=new_value, is_old0=is_old0,
            fnc=(fnc0, fnc1),
        )

    def set_witness(self, pw, witness: SparseMerkleProcessProof) -> None:
        """``process_smt.rs:82-117`` including its validity asserts."""
        n_levels = len(self.siblings)
        if len(witness.siblings) >= n_levels:
            raise AssertionError("siblings are too long")
        if not witness.is_old0:
            fdi = first_different_bit_index(witness.old_key, witness.new_key)
            if fdi is not None and fdi >= n_levels:
                raise AssertionError("invalid `new_key`")
        for i in range(n_levels):
            sib = witness.siblings[i] if i < len(witness.siblings) else HashOut.ZERO
            pw.set_hash_target(self.siblings[i], sib)
        pw.set_hash_target(self.old_root, witness.old_root)
        pw.set_hash_target(self.new_root, witness.new_root)
        pw.set_hash_target(self.old_key, witness.old_key)
        pw.set_hash_target(self.old_value, witness.old_value)
        pw.set_hash_target(self.new_key, witness.new_key)
        pw.set_hash_target(self.new_value, witness.new_value)
        pw.set_bool_target(self.is_old0, witness.is_old0)
        b0, b1 = witness.fnc.to_bools()
        pw.set_bool_target(self.fnc[0], b0)
        pw.set_bool_target(self.fnc[1], b1)
