"""Approval-block gadget (reference
``src/rollup/gadgets/approval_block/mod.rs``): applies signatures, reverts
unsigned purges, and updates the latest-account tree."""

from __future__ import annotations

from dataclasses import dataclass

from ....engine.circuit import BoolTarget, CircuitBuilder, HashOutTarget
from ....utils.hash_out import HashOut
from ...sparse_merkle_tree.gadgets.common import (
    conditionally_select,
    enforce_equal_if_enabled,
)
from ...sparse_merkle_tree.gadgets.process import SparseMerkleProcessProofTarget
from ...sparse_merkle_tree.proofs import SparseMerkleProcessProof
from ...transaction.circuits import (
    MergeAndPurgeTransitionPublicInputs,
    MergeAndPurgeTransitionPublicInputsTarget,
)
from ...zkdsa.circuits import SimpleSignaturePublicInputs, SimpleSignaturePublicInputsTarget


@dataclass
class WorldStateRevertTransitionTarget:
    world_state_revert_proof: SparseMerkleProcessProofTarget
    user_transaction: MergeAndPurgeTransitionPublicInputsTarget
    received_signature: tuple[SimpleSignaturePublicInputsTarget, BoolTarget]
    latest_account_process_proof: SparseMerkleProcessProofTarget
    enabled: BoolTarget


@dataclass
class ApprovalBlockProductionTarget:
    current_block_number: int  # target
    world_state_revert_transitions: list[WorldStateRevertTransitionTarget]
    old_world_state_root: HashOutTarget
    new_world_state_root: HashOutTarget
    old_latest_account_root: HashOutTarget
    new_latest_account_root: HashOutTarget
    log_max_n_users: int

    @classmethod
    def add_virtual_to(
        cls, builder: CircuitBuilder, log_max_n_users: int, n_txs: int
    ) -> "ApprovalBlockProductionTarget":
        current_block_number = builder.add_virtual_target()
        transitions = []
        for _ in range(n_txs):
            transitions.append(
                WorldStateRevertTransitionTarget(
                    world_state_revert_proof=SparseMerkleProcessProofTarget.add_virtual_to(
                        builder, log_max_n_users
                    ),
                    user_transaction=MergeAndPurgeTransitionPublicInputsTarget.add_virtual_to(
                        builder
                    ),
                    received_signature=(
                        SimpleSignaturePublicInputsTarget.add_virtual_to(builder),
                        builder.add_virtual_bool_target_safe(),
                    ),
                    latest_account_process_proof=SparseMerkleProcessProofTarget.add_virtual_to(
                        builder, log_max_n_users
                    ),
                    enabled=builder.add_virtual_bool_target_safe(),
                )
            )
        old_world_state_root = builder.add_virtual_hash()
        old_latest_account_root = builder.add_virtual_hash()
        new_world_state_root, new_latest_account_root = verify_valid_approval_block(
            builder, current_block_number, transitions, old_world_state_root,
            old_latest_account_root,
        )
        return cls(
            current_block_number=current_block_number,
            world_state_revert_transitions=transitions,
            old_world_state_root=old_world_state_root,
            new_world_state_root=new_world_state_root,
            old_latest_account_root=old_latest_account_root,
            new_latest_account_root=new_latest_account_root,
            log_max_n_users=log_max_n_users,
        )

    def set_witness(
        self,
        pw,
        current_block_number: int,
        world_state_revert_proofs: list[SparseMerkleProcessProof],
        user_transactions: list[MergeAndPurgeTransitionPublicInputs],
        received_signatures: list[SimpleSignaturePublicInputs | None],
        latest_account_tree_process_proofs: list[SparseMerkleProcessProof],
        old_world_state_root: HashOut,
        old_latest_account_root: HashOut,
    ):
        """``approval_block/mod.rs:115-280``.  Returns
        (new_world_state_root, new_latest_account_root)."""
        pw.set_hash_target(self.old_world_state_root, old_world_state_root)
        pw.set_hash_target(self.old_latest_account_root, old_latest_account_root)

        prev_ws = old_world_state_root
        prev_la = old_latest_account_root
        for w, a in zip(world_state_revert_proofs, latest_account_tree_process_proofs):
            assert w.old_root == prev_ws
            assert a.old_root == prev_la
            prev_ws = w.new_root
            prev_la = a.new_root
        new_world_state_root = prev_ws
        new_latest_account_root = prev_la

        for (w, u), (r, a) in zip(
            zip(world_state_revert_proofs, user_transactions),
            zip(received_signatures, latest_account_tree_process_proofs),
        ):
            assert w.old_value == u.new_user_asset_root
            if r is not None:
                assert r.message == old_world_state_root
                assert w.new_value == u.new_user_asset_root
                expected_new_last_block_number = HashOut.from_u32(current_block_number)
            else:
                assert w.new_value == u.middle_user_asset_root
                expected_new_last_block_number = a.old_value
            assert a.new_value == expected_new_last_block_number

        pw.set_target(self.current_block_number, current_block_number)
        for t, w in zip(self.world_state_revert_transitions, world_state_revert_proofs):
            t.world_state_revert_proof.set_witness(pw, w)
        default_proof = SparseMerkleProcessProof.with_root(new_world_state_root)
        for t in self.world_state_revert_transitions[len(world_state_revert_proofs):]:
            t.world_state_revert_proof.set_witness(pw, default_proof)

        for t, u in zip(self.world_state_revert_transitions, user_transactions):
            t.user_transaction.set_witness(pw, u)
        for t in self.world_state_revert_transitions[len(user_transactions):]:
            t.user_transaction.set_witness(pw, MergeAndPurgeTransitionPublicInputs.default())

        for t, r in zip(self.world_state_revert_transitions, received_signatures):
            t.received_signature[0].set_witness(
                pw, r if r is not None else SimpleSignaturePublicInputs.default()
            )
            pw.set_bool_target(t.received_signature[1], r is not None)
        for t in self.world_state_revert_transitions[len(received_signatures):]:
            t.received_signature[0].set_witness(pw, SimpleSignaturePublicInputs.default())
            pw.set_bool_target(t.received_signature[1], False)

        for t in self.world_state_revert_transitions[: len(user_transactions)]:
            pw.set_bool_target(t.enabled, True)
        for t in self.world_state_revert_transitions[len(user_transactions):]:
            pw.set_bool_target(t.enabled, False)

        for t, a in zip(
            self.world_state_revert_transitions, latest_account_tree_process_proofs
        ):
            t.latest_account_process_proof.set_witness(pw, a)
        default_proof = SparseMerkleProcessProof.with_root(new_latest_account_root)
        for t in self.world_state_revert_transitions[
            len(latest_account_tree_process_proofs):
        ]:
            t.latest_account_process_proof.set_witness(pw, default_proof)

        return new_world_state_root, new_latest_account_root


def verify_valid_approval_block(
    builder: CircuitBuilder,
    current_block_number: int,
    transitions: list[WorldStateRevertTransitionTarget],
    old_world_state_root: HashOutTarget,
    old_latest_account_root: HashOutTarget,
):
    """``approval_block/mod.rs:287-354``."""
    zero = builder.zero()

    prev_ws = old_world_state_root
    prev_la = old_latest_account_root
    for t in transitions:
        builder.connect_hashes(t.world_state_revert_proof.old_root, prev_ws)
        builder.connect_hashes(t.latest_account_process_proof.old_root, prev_la)
        prev_ws = t.world_state_revert_proof.new_root
        prev_la = t.latest_account_process_proof.new_root
    new_world_state_root = prev_ws
    new_latest_account_root = prev_la

    for t in transitions:
        w = t.world_state_revert_proof
        u = t.user_transaction
        signature, enabled_signature = t.received_signature
        a = t.latest_account_process_proof

        # the signature must sign the proposed world-state root
        enforce_equal_if_enabled(
            builder, signature.message, old_world_state_root, enabled_signature
        )
        enforce_equal_if_enabled(builder, w.old_value, u.new_user_asset_root, t.enabled)
        expected_new_root = conditionally_select(
            builder, u.new_user_asset_root, u.middle_user_asset_root, enabled_signature
        )
        enforce_equal_if_enabled(builder, w.new_value, expected_new_root, t.enabled)

        old_last = list(a.old_value)[0]
        builder.connect(list(a.old_value)[1], zero)
        builder.connect(list(a.old_value)[2], zero)
        builder.connect(list(a.old_value)[3], zero)
        new_last = list(a.new_value)[0]
        builder.connect(list(a.new_value)[1], zero)
        builder.connect(list(a.new_value)[2], zero)
        builder.connect(list(a.new_value)[3], zero)
        expected_new_last = builder.select(
            enabled_signature, current_block_number, old_last
        )
        builder.connect(expected_new_last, new_last)

    return new_world_state_root, new_latest_account_root
