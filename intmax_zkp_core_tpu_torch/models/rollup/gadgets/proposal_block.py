"""Proposal-block gadget (reference
``src/rollup/gadgets/proposal_block/mod.rs``): chains world-state process
proofs against user transactions and computes the transactions digest."""

from __future__ import annotations

from dataclasses import dataclass

from ....engine.circuit import BoolTarget, CircuitBuilder, HashOutTarget
from ....utils.hash_out import HashOut
from ....utils.poseidon_host import two_to_one
from ...merkle_tree.gadgets import get_merkle_root_target_from_leaves
from ...merkle_tree.tree import get_merkle_proof_with_zero, log2_ceil
from ...sparse_merkle_tree.gadgets.common import logical_or
from ...sparse_merkle_tree.gadgets.process import (
    SparseMerkleProcessProofTarget,
    get_process_merkle_proof_role,
    verify_layered_smt_target_connection,
)
from ...sparse_merkle_tree.layered import verify_layered_smt_connection
from ...sparse_merkle_tree.proofs import ProcessMerkleProofRole, SparseMerkleProcessProof
from ...transaction.circuits import (
    MergeAndPurgeTransitionPublicInputs,
    MergeAndPurgeTransitionPublicInputsTarget,
)


@dataclass
class WorldStateProcessTransitionTarget:
    world_state_process_proof: SparseMerkleProcessProofTarget
    user_transaction: MergeAndPurgeTransitionPublicInputsTarget
    enabled: BoolTarget


@dataclass
class ProposalBlockProductionTarget:
    world_state_process_transitions: list[WorldStateProcessTransitionTarget]
    transactions_digest: HashOutTarget  # output
    old_world_state_root: HashOutTarget  # input
    new_world_state_root: HashOutTarget  # output
    log_max_n_users: int

    @classmethod
    def add_virtual_to(
        cls, builder: CircuitBuilder, log_max_n_users: int, n_txs: int
    ) -> "ProposalBlockProductionTarget":
        assert n_txs & (n_txs - 1) == 0, "n_txs must be a power of two"
        transitions = []
        for _ in range(n_txs):
            transitions.append(
                WorldStateProcessTransitionTarget(
                    world_state_process_proof=SparseMerkleProcessProofTarget.add_virtual_to(
                        builder, log_max_n_users
                    ),
                    user_transaction=MergeAndPurgeTransitionPublicInputsTarget.add_virtual_to(
                        builder
                    ),
                    enabled=builder.add_virtual_bool_target_safe(),
                )
            )
        old_world_state_root = builder.add_virtual_hash()
        transactions_digest, new_world_state_root = verify_valid_proposal_block(
            builder, transitions, old_world_state_root
        )
        return cls(
            world_state_process_transitions=transitions,
            transactions_digest=transactions_digest,
            old_world_state_root=old_world_state_root,
            new_world_state_root=new_world_state_root,
            log_max_n_users=log_max_n_users,
        )

    def set_witness(
        self,
        pw,
        world_state_process_proofs: list[SparseMerkleProcessProof],
        user_transactions: list[MergeAndPurgeTransitionPublicInputs],
        old_world_state_root: HashOut,
    ):
        """``proposal_block/mod.rs:97-198``.  Returns
        (transactions_digest, new_world_state_root)."""
        n_txs = len(self.world_state_process_transitions)
        pw.set_hash_target(self.old_world_state_root, old_world_state_root)

        for w, u in zip(world_state_process_proofs, user_transactions):
            assert w.fnc != ProcessMerkleProofRole.ProcessDelete, (
                "not allowed removing nodes in world state tree"
            )
            verify_layered_smt_connection(
                w.fnc, w.old_value, w.new_value, u.old_user_asset_root, u.new_user_asset_root
            )

        assert len(world_state_process_proofs) <= n_txs
        prev = old_world_state_root
        for t, p in zip(self.world_state_process_transitions, world_state_process_proofs):
            assert p.old_root == prev
            prev = p.new_root
            t.world_state_process_proof.set_witness(pw, p)
        new_world_state_root = prev

        default_proof = SparseMerkleProcessProof.with_root(new_world_state_root)
        for t in self.world_state_process_transitions[len(world_state_process_proofs):]:
            t.world_state_process_proof.set_witness(pw, default_proof)

        assert len(user_transactions) == len(world_state_process_proofs)
        for t, u in zip(self.world_state_process_transitions, user_transactions):
            t.user_transaction.set_witness(pw, u)
            pw.set_bool_target(t.enabled, True)
        for t in self.world_state_process_transitions[len(user_transactions):]:
            t.user_transaction.set_witness(
                pw, MergeAndPurgeTransitionPublicInputs.default()
            )
            pw.set_bool_target(t.enabled, False)

        tx_hashes = [u.tx_hash for u in user_transactions]
        default_tx_hash = MergeAndPurgeTransitionPublicInputs.default().tx_hash
        log_n_txs = log2_ceil(n_txs)
        assert 1 << log_n_txs == n_txs
        transactions_digest = get_merkle_proof_with_zero(
            tx_hashes, 0, log_n_txs, default_tx_hash
        ).root if tx_hashes else get_merkle_proof_with_zero(
            [], 0, log_n_txs, default_tx_hash
        ).root
        return transactions_digest, new_world_state_root


def verify_valid_proposal_block(
    builder: CircuitBuilder,
    transitions: list[WorldStateProcessTransitionTarget],
    old_world_state_root: HashOutTarget,
):
    """``proposal_block/mod.rs:200-255``."""
    # chained world-state roots (hard connections)
    new_world_state_root = old_world_state_root
    for t in transitions:
        builder.connect_hashes(t.world_state_process_proof.old_root, new_world_state_root)
        new_world_state_root = t.world_state_process_proof.new_root

    for t in transitions:
        w = t.world_state_process_proof
        u = t.user_transaction
        role = get_process_merkle_proof_role(builder, w.fnc)
        # disabled tx => noop process; never delete
        is_no_op_or_enabled = logical_or(builder, role.is_no_op, t.enabled)
        builder.assert_one(is_no_op_or_enabled.target)
        builder.assert_zero(role.is_remove_op.target)
        verify_layered_smt_target_connection(
            builder, w.fnc, w.old_value, w.new_value, u.old_user_asset_root, u.new_user_asset_root
        )

    tx_hashes = [t.user_transaction.tx_hash for t in transitions]
    transactions_digest = get_merkle_root_target_from_leaves(builder, tx_hashes)
    return transactions_digest, new_world_state_root
