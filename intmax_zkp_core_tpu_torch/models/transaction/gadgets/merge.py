"""Merge gadget: verifies insertion of received assets (deposits or
transfers) into the user asset tree (reference
``src/transaction/gadgets/merge/mod.rs``).

Note on the reference's ``// XXX`` relaxations: the reference disables the
in-circuit ``merge_key``/inclusion-root equality checks
(``merge/mod.rs:314-319,363``) but enforces them in ``set_witness``.  Per
the survey's guidance (``SURVEY.md`` §7 quirks) this rebuild enforces them
in-circuit as well.
"""

from __future__ import annotations

from dataclasses import dataclass

from ....engine.circuit import BoolTarget, CircuitBuilder, HashOutTarget
from ....utils.hash_out import HashOut
from ....utils.poseidon_host import two_to_one
from ...merkle_tree.gadgets import MerkleProofTarget
from ...merkle_tree.tree import MerkleProof
from ...sparse_merkle_tree.gadgets.common import (
    conditionally_select,
    enforce_equal_if_enabled,
    poseidon_two_to_one,
)
from ...sparse_merkle_tree.gadgets.process import (
    SparseMerkleProcessProofTarget,
    get_process_merkle_proof_role,
)
from ...sparse_merkle_tree.gadgets.verify import SparseMerkleInclusionProofTarget
from ...sparse_merkle_tree.proofs import (
    ProcessMerkleProofRole,
    SparseMerkleInclusionProof,
    SparseMerkleProcessProof,
)
from ..block_header import BlockHeader, get_block_hash
from .block_header import BlockHeaderTarget, get_block_hash_target, hash_out_target_from_partial


@dataclass
class MergeProof:
    """Witness for one merge (``merge/mod.rs:36-51``)."""

    is_deposit: bool
    # (block header, tx/deposit-tree dense proof, diff-tree SMT inclusion)
    diff_tree_inclusion_proof: tuple[BlockHeader, MerkleProof, SparseMerkleInclusionProof]
    merge_process_proof: SparseMerkleProcessProof
    latest_account_tree_inclusion_proof: SparseMerkleInclusionProof
    nonce: HashOut

    def to_json(self) -> dict:
        """Reference serde layout (``merge/mod.rs:36-50``): snake_case
        fields, the inclusion-proof tuple as a 3-element JSON array —
        the checkpoint format of a merge witness (SURVEY §5.4)."""
        bh, mp, ip = self.diff_tree_inclusion_proof
        return {
            "is_deposit": self.is_deposit,
            "diff_tree_inclusion_proof": [bh.to_json(), mp.to_json(), ip.to_json()],
            "merge_process_proof": self.merge_process_proof.to_json(),
            "latest_account_tree_inclusion_proof": (
                self.latest_account_tree_inclusion_proof.to_json()
            ),
            "nonce": self.nonce.to_hex(),
        }

    @classmethod
    def from_json(cls, o: dict) -> "MergeProof":
        bh, mp, ip = o["diff_tree_inclusion_proof"]
        return cls(
            is_deposit=o["is_deposit"],
            diff_tree_inclusion_proof=(
                BlockHeader.from_json(bh),
                MerkleProof.from_json(mp),
                SparseMerkleInclusionProof.from_json(ip),
            ),
            merge_process_proof=SparseMerkleProcessProof.from_json(
                o["merge_process_proof"]
            ),
            latest_account_tree_inclusion_proof=SparseMerkleInclusionProof.from_json(
                o["latest_account_tree_inclusion_proof"]
            ),
            nonce=HashOut.from_hex(o["nonce"]),
        )


@dataclass
class MergeProofTarget:
    diff_tree_inclusion_proof: tuple[
        BlockHeaderTarget, MerkleProofTarget, SparseMerkleInclusionProofTarget
    ]
    merge_process_proof: SparseMerkleProcessProofTarget
    latest_account_tree_inclusion_proof: SparseMerkleInclusionProofTarget
    nonce: HashOutTarget


@dataclass
class MergeTransitionTarget:
    proofs: list[MergeProofTarget]
    old_user_asset_root: HashOutTarget
    new_user_asset_root: HashOutTarget
    log_max_n_users: int
    log_max_n_txs: int
    log_n_txs: int
    log_n_recipients: int

    @classmethod
    def add_virtual_to(
        cls,
        builder: CircuitBuilder,
        log_max_n_users: int,
        log_max_n_txs: int,
        log_n_txs: int,
        log_n_recipients: int,
        n_merges: int,
    ) -> "MergeTransitionTarget":
        proofs = []
        for _ in range(n_merges):
            proofs.append(
                MergeProofTarget(
                    diff_tree_inclusion_proof=(
                        BlockHeaderTarget.add_virtual_to(builder),
                        MerkleProofTarget.add_virtual_to(builder, log_n_txs),
                        SparseMerkleInclusionProofTarget.add_virtual_to(
                            builder, log_n_recipients
                        ),
                    ),
                    merge_process_proof=SparseMerkleProcessProofTarget.add_virtual_to(
                        builder, log_max_n_txs
                    ),
                    latest_account_tree_inclusion_proof=(
                        SparseMerkleInclusionProofTarget.add_virtual_to(builder, log_max_n_users)
                    ),
                    nonce=builder.add_virtual_hash(),
                )
            )
        old_user_asset_root = builder.add_virtual_hash()
        new_user_asset_root = verify_user_asset_merge_proof(
            builder, proofs, old_user_asset_root
        )
        return cls(
            proofs=proofs,
            old_user_asset_root=old_user_asset_root,
            new_user_asset_root=new_user_asset_root,
            log_max_n_users=log_max_n_users,
            log_max_n_txs=log_max_n_txs,
            log_n_txs=log_n_txs,
            log_n_recipients=log_n_recipients,
        )

    def set_witness(self, pw, proofs: list[MergeProof], old_user_asset_root: HashOut) -> HashOut:
        """``merge/mod.rs:128-274``; mirrors all in-circuit checks as host
        asserts and pads unused slots with defaults."""
        pw.set_hash_target(self.old_user_asset_root, old_user_asset_root)

        if proofs:
            assert proofs[0].merge_process_proof.old_root == old_user_asset_root

        new_user_asset_root = old_user_asset_root
        assert len(proofs) <= len(self.proofs)
        for target, witness in zip(self.proofs, proofs):
            assert witness.merge_process_proof.fnc != ProcessMerkleProofRole.ProcessNoOp
            header = witness.diff_tree_inclusion_proof[0]
            root = header.deposit_digest if witness.is_deposit else header.transactions_digest
            assert root == witness.diff_tree_inclusion_proof[1].root
            block_hash = get_block_hash(header)

            if witness.is_deposit:
                network_index = HashOut((witness.diff_tree_inclusion_proof[1].index, 0, 0, 0))
                assert witness.nonce == network_index
            diff_root = witness.diff_tree_inclusion_proof[2].root
            tx_hash = two_to_one(diff_root, witness.nonce)
            assert witness.diff_tree_inclusion_proof[1].value == tx_hash

            merge_key = two_to_one(tx_hash, block_hash) if witness.is_deposit else tx_hash
            assert witness.merge_process_proof.new_key == merge_key
            assert witness.merge_process_proof.fnc == ProcessMerkleProofRole.ProcessInsert
            asset_root = witness.diff_tree_inclusion_proof[2].value
            assert witness.merge_process_proof.new_value == two_to_one(asset_root, merge_key)
            assert (
                header.latest_account_digest
                == witness.latest_account_tree_inclusion_proof.root
            )
            assert witness.merge_process_proof.old_root == new_user_asset_root

            if not witness.is_deposit:
                confirmed = witness.latest_account_tree_inclusion_proof.value
                assert confirmed == HashOut((header.block_number, 0, 0, 0))

            target.diff_tree_inclusion_proof[0].set_witness(pw, header)
            target.diff_tree_inclusion_proof[1].set_witness(
                pw,
                witness.diff_tree_inclusion_proof[1].index,
                witness.diff_tree_inclusion_proof[1].value,
                witness.diff_tree_inclusion_proof[1].siblings,
            )
            target.diff_tree_inclusion_proof[2].set_witness(
                pw, witness.diff_tree_inclusion_proof[2], True
            )
            target.merge_process_proof.set_witness(pw, witness.merge_process_proof)
            # the latest-account check only applies to transfers
            target.latest_account_tree_inclusion_proof.set_witness(
                pw, witness.latest_account_tree_inclusion_proof, not witness.is_deposit
            )
            pw.set_hash_target(target.nonce, witness.nonce)
            new_user_asset_root = witness.merge_process_proof.new_root

        default_header = BlockHeader.new(self.log_n_txs)
        default_merkle_proof = MerkleProof.new(self.log_n_txs)
        default_inclusion = SparseMerkleInclusionProof.with_root(HashOut.ZERO)
        default_process = SparseMerkleProcessProof.with_root(new_user_asset_root)
        for target in self.proofs[len(proofs):]:
            target.diff_tree_inclusion_proof[0].set_witness(pw, default_header)
            target.diff_tree_inclusion_proof[1].set_witness(
                pw,
                default_merkle_proof.index,
                default_merkle_proof.value,
                default_merkle_proof.siblings,
            )
            target.diff_tree_inclusion_proof[2].set_witness(pw, default_inclusion, False)
            target.merge_process_proof.set_witness(pw, default_process)
            target.latest_account_tree_inclusion_proof.set_witness(pw, default_inclusion, False)
            pw.set_hash_target(target.nonce, HashOut.ZERO)

        return new_user_asset_root


def verify_user_asset_merge_proof(
    builder: CircuitBuilder, proofs: list[MergeProofTarget], old_user_asset_root: HashOutTarget
) -> HashOutTarget:
    """``merge/mod.rs:277-401`` (with the XXX'd checks enforced)."""
    new_user_asset_root = old_user_asset_root
    for proof in proofs:
        mp = proof.merge_process_proof
        incl1 = proof.diff_tree_inclusion_proof[1]
        incl2 = proof.diff_tree_inclusion_proof[2]
        latest = proof.latest_account_tree_inclusion_proof
        header_t = proof.diff_tree_inclusion_proof[0]

        role = get_process_merkle_proof_role(builder, mp.fnc)
        is_not_no_op = role.is_not_no_op
        is_transfer = builder.and_(latest.enabled, is_not_no_op)
        is_not_transfer = builder.not_(is_transfer)
        is_deposit = builder.and_(is_not_transfer, is_not_no_op)

        root = conditionally_select(
            builder, header_t.transactions_digest, header_t.deposit_digest, is_transfer
        )
        # enforced here although the reference XXX'd it out (merge/mod.rs:314-319)
        enforce_equal_if_enabled(builder, root, incl1.root, is_not_no_op)

        # transfer: the sender's tx was approved at receiving_block_number
        confirmed_block_number = latest.value
        rbn = hash_out_target_from_partial(builder, [header_t.block_number])
        enforce_equal_if_enabled(builder, confirmed_block_number, rbn, is_transfer)

        # deposit: nonce == network index
        network_index = hash_out_target_from_partial(builder, [incl1.index])
        enforce_equal_if_enabled(builder, proof.nonce, network_index, is_deposit)

        # tx_hash = Poseidon(diff_root || nonce) consistency
        incl1_value = poseidon_two_to_one(builder, incl2.root, proof.nonce)
        enforce_equal_if_enabled(builder, incl1.value, incl1_value, is_not_no_op)

        # merge_key differs for deposit vs transfer
        block_hash = get_block_hash_target(builder, header_t)
        tx_hash = incl1.value
        deposit_merge_key = poseidon_two_to_one(builder, tx_hash, block_hash)
        merge_key = conditionally_select(builder, tx_hash, deposit_merge_key, is_transfer)
        # enforced here although the reference XXX'd it out (merge/mod.rs:363)
        enforce_equal_if_enabled(builder, mp.new_key, merge_key, is_not_no_op)

        # non-noop merges are inserts
        builder.connect(is_not_no_op.target, role.is_insert_op.target)

        asset_root = incl2.value
        asset_root_with_merge_key = poseidon_two_to_one(builder, asset_root, merge_key)
        enforce_equal_if_enabled(builder, mp.new_value, asset_root_with_merge_key, is_not_no_op)
        enforce_equal_if_enabled(
            builder, header_t.latest_account_digest, latest.root, is_not_no_op
        )
        enforce_equal_if_enabled(builder, mp.old_root, new_user_asset_root, is_not_no_op)

        new_user_asset_root = conditionally_select(
            builder, mp.new_root, new_user_asset_root, is_not_no_op
        )
    return new_user_asset_root
