"""Purge gadget: asset removal from the user asset tree + tx-diff tree
creation, with asset conservation (reference
``src/transaction/gadgets/purge/mod.rs``)."""

from __future__ import annotations

from dataclasses import dataclass

from ....engine.circuit import CircuitBuilder, HashOutTarget
from ....utils.hash_out import HashOut
from ....utils.poseidon_host import two_to_one
from ...sparse_merkle_tree.gadgets.common import (
    conditionally_select,
    logical_xor,
    poseidon_two_to_one,
)
from ...sparse_merkle_tree.gadgets.process import (
    SparseMerkleProcessProofTarget,
    get_process_merkle_proof_role,
    verify_layered_smt_target_connection,
)
from ...sparse_merkle_tree.layered import verify_layered_smt_connection
from ...sparse_merkle_tree.proofs import ProcessMerkleProofRole, SparseMerkleProcessProof
from ...zkdsa.account import Address
from ...zkdsa.account_gadgets import AddressTarget
from .asset_mess import AssetTargets, verify_equal_assets

ProcessTriple = tuple[
    SparseMerkleProcessProofTarget,
    SparseMerkleProcessProofTarget,
    SparseMerkleProcessProofTarget,
]


@dataclass
class PurgeTransitionTarget:
    sender_address: AddressTarget
    input_proofs: list[ProcessTriple]
    output_proofs: list[ProcessTriple]
    old_user_asset_root: HashOutTarget
    new_user_asset_root: HashOutTarget
    diff_root: HashOutTarget
    nonce: HashOutTarget
    tx_hash: HashOutTarget
    log_max_n_txs: int
    log_max_n_contracts: int
    log_max_n_variables: int
    log_n_recipients: int
    log_n_contracts: int
    log_n_variables: int

    @classmethod
    def add_virtual_to(
        cls,
        builder: CircuitBuilder,
        log_max_n_txs: int,
        log_max_n_contracts: int,
        log_max_n_variables: int,
        log_n_recipients: int,
        log_n_contracts: int,
        log_n_variables: int,
        n_diffs: int,
    ) -> "PurgeTransitionTarget":
        sender_address = AddressTarget.add_virtual_to(builder)
        old_user_asset_root = builder.add_virtual_hash()
        nonce = builder.add_virtual_hash()
        input_proofs = [
            (
                SparseMerkleProcessProofTarget.add_virtual_to(builder, log_max_n_txs),
                SparseMerkleProcessProofTarget.add_virtual_to(builder, log_max_n_contracts),
                SparseMerkleProcessProofTarget.add_virtual_to(builder, log_max_n_variables),
            )
            for _ in range(n_diffs)
        ]
        output_proofs = [
            (
                SparseMerkleProcessProofTarget.add_virtual_to(builder, log_n_recipients),
                SparseMerkleProcessProofTarget.add_virtual_to(builder, log_n_contracts),
                SparseMerkleProcessProofTarget.add_virtual_to(builder, log_n_variables),
            )
            for _ in range(n_diffs)
        ]
        new_user_asset_root, diff_root, tx_hash = verify_user_asset_purge_proof(
            builder, input_proofs, output_proofs, old_user_asset_root, nonce
        )
        return cls(
            sender_address=sender_address,
            input_proofs=input_proofs,
            output_proofs=output_proofs,
            old_user_asset_root=old_user_asset_root,
            new_user_asset_root=new_user_asset_root,
            diff_root=diff_root,
            nonce=nonce,
            tx_hash=tx_hash,
            log_max_n_txs=log_max_n_txs,
            log_max_n_contracts=log_max_n_contracts,
            log_max_n_variables=log_max_n_variables,
            log_n_recipients=log_n_recipients,
            log_n_contracts=log_n_contracts,
            log_n_variables=log_n_variables,
        )

    def set_witness(
        self,
        pw,
        sender_address: Address,
        input_witness,
        output_witness,
        old_user_asset_root: HashOut,
        nonce: HashOut,
    ):
        """``purge/mod.rs:143-299``.  Returns (new_user_asset_root,
        diff_root, tx_hash)."""
        self.sender_address.set_witness(pw, sender_address)
        pw.set_hash_target(self.old_user_asset_root, old_user_asset_root)
        pw.set_hash_target(self.nonce, nonce)

        assert len(input_witness) <= len(self.input_proofs)
        prev_root = old_user_asset_root
        for i, ((p0, p1, p2), (w0, w1, w2)) in enumerate(
            zip(self.input_proofs, input_witness)
        ):
            assert w0.old_root == prev_root
            prev_root = w0.new_root
            merge_key = w0.new_key
            old_root_with_nonce = two_to_one(w1.old_root, merge_key)
            new_root_with_nonce = two_to_one(w1.new_root, merge_key)
            assert w0.fnc == ProcessMerkleProofRole.ProcessUpdate, (
                "first Merkle proof is update proof"
            )
            verify_layered_smt_connection(
                w0.fnc, w0.old_value, w0.new_value, old_root_with_nonce, new_root_with_nonce
            )
            assert w1.fnc in (
                ProcessMerkleProofRole.ProcessUpdate,
                ProcessMerkleProofRole.ProcessDelete,
            )
            verify_layered_smt_connection(
                w1.fnc, w1.old_value, w1.new_value, w2.old_root, w2.new_root
            )
            assert w2.fnc == ProcessMerkleProofRole.ProcessDelete
            assert w2.old_value.elements[0] < 1 << 56
            assert w2.old_value.elements[1:] == (0, 0, 0)
            p0.set_witness(pw, w0)
            p1.set_witness(pw, w1)
            p2.set_witness(pw, w2)
        new_user_asset_root = prev_root

        d0 = SparseMerkleProcessProof.with_root(new_user_asset_root)
        d1 = SparseMerkleProcessProof.with_root(HashOut.ZERO)
        for p0, p1, p2 in self.input_proofs[len(input_witness):]:
            p0.set_witness(pw, d0)
            p1.set_witness(pw, d1)
            p2.set_witness(pw, d1)

        assert len(output_witness) <= len(self.output_proofs)
        prev_diff_root = HashOut.ZERO
        for i, ((p0, p1, p2), (w0, w1, w2)) in enumerate(
            zip(self.output_proofs, output_witness)
        ):
            assert w0.old_root == prev_diff_root
            prev_diff_root = w0.new_root
            assert w0.fnc in (
                ProcessMerkleProofRole.ProcessUpdate,
                ProcessMerkleProofRole.ProcessInsert,
            )
            verify_layered_smt_connection(
                w0.fnc, w0.old_value, w0.new_value, w1.old_root, w1.new_root
            )
            assert w1.fnc in (
                ProcessMerkleProofRole.ProcessUpdate,
                ProcessMerkleProofRole.ProcessInsert,
            )
            verify_layered_smt_connection(
                w1.fnc, w1.old_value, w1.new_value, w2.old_root, w2.new_root
            )
            assert w2.fnc == ProcessMerkleProofRole.ProcessInsert, (
                "third Merkle proof is insert proof"
            )
            assert w2.old_value.elements[0] < 1 << 56
            assert w2.old_value.elements[1:] == (0, 0, 0)
            p0.set_witness(pw, w0)
            p1.set_witness(pw, w1)
            p2.set_witness(pw, w2)
        diff_root = prev_diff_root

        d0 = SparseMerkleProcessProof.with_root(diff_root)
        for p0, p1, p2 in self.output_proofs[len(output_witness):]:
            p0.set_witness(pw, d0)
            p1.set_witness(pw, d1)
            p2.set_witness(pw, d1)

        tx_hash = two_to_one(diff_root, nonce)
        return new_user_asset_root, diff_root, tx_hash


def verify_user_asset_purge_proof(
    builder: CircuitBuilder,
    input_proofs_t: list[ProcessTriple],
    output_proofs_t: list[ProcessTriple],
    old_user_asset_root: HashOutTarget,
    nonce: HashOutTarget,
):
    """``purge/mod.rs:303-437``.  Returns (new_user_asset_root, diff_root,
    tx_hash)."""
    default_hash = builder.zero_hash()
    zero = builder.zero()
    assert len(input_proofs_t) == len(output_proofs_t)

    input_assets = []
    for p0, p1, p2 in input_proofs_t:
        is_no_op = get_process_merkle_proof_role(builder, p0.fnc).is_no_op
        merge_key = p0.new_key
        # user-asset layer-0 value = Poseidon(layer1_root || merge_key)
        old_rwn = poseidon_two_to_one(builder, p1.old_root, merge_key)
        old_rwn = conditionally_select(builder, default_hash, old_rwn, is_no_op)
        new_rwn = poseidon_two_to_one(builder, p1.new_root, merge_key)
        new_rwn = conditionally_select(builder, default_hash, new_rwn, is_no_op)
        verify_layered_smt_target_connection(
            builder, p0.fnc, p0.old_value, p0.new_value, old_rwn, new_rwn
        )
        verify_layered_smt_target_connection(
            builder, p1.fnc, p1.old_value, p1.new_value, p2.old_root, p2.new_root
        )
        # p2 delete-op constraint relaxed in the reference (purge/mod.rs:360-364 XXX);
        # the removed amount is range-checked < 2^56, upper limbs zero
        builder.range_check(list(p2.old_value)[0], 56)
        builder.connect(list(p2.old_value)[1], zero)
        builder.connect(list(p2.old_value)[2], zero)
        builder.connect(list(p2.old_value)[3], zero)
        input_assets.append(
            AssetTargets(
                contract_address=p1.old_key,
                token_id=p2.old_key,
                amount=list(p2.old_value)[0],
            )
        )

    prev = old_user_asset_root
    for p0, _, _ in input_proofs_t:
        builder.connect_hashes(prev, p0.old_root)
        prev = p0.new_root
    new_user_asset_root = prev

    output_assets = []
    for p0, p1, p2 in output_proofs_t:
        verify_layered_smt_target_connection(
            builder, p0.fnc, p0.old_value, p0.new_value, p1.old_root, p1.new_root
        )
        verify_layered_smt_target_connection(
            builder, p1.fnc, p1.old_value, p1.new_value, p2.old_root, p2.new_root
        )
        # p2 must be insert or noop: !fnc[1] (purge/mod.rs:408-409)
        is_insert_or_no_op = builder.not_(p2.fnc[1])
        builder.assert_one(is_insert_or_no_op.target)
        builder.range_check(list(p2.new_value)[0], 56)
        builder.connect(list(p2.new_value)[1], zero)
        builder.connect(list(p2.new_value)[2], zero)
        builder.connect(list(p2.new_value)[3], zero)
        output_assets.append(
            AssetTargets(
                contract_address=p1.new_key,
                token_id=p2.new_key,
                amount=list(p2.new_value)[0],
            )
        )

    prev = default_hash
    for p0, _, _ in output_proofs_t:
        builder.connect_hashes(prev, p0.old_root)
        prev = p0.new_root
    diff_root = prev

    verify_equal_assets(builder, input_assets, output_assets)

    tx_hash = poseidon_two_to_one(builder, diff_root, nonce)
    return new_user_asset_root, diff_root, tx_hash
