"""Block header and block-hash computation (reference
``src/transaction/block_header.rs``)."""

from __future__ import annotations

from dataclasses import dataclass

from ...config import LOG_MAX_N_BLOCKS
from ...utils.hash_out import HashOut
from ...utils.poseidon_host import two_to_one
from ..merkle_tree.tree import get_merkle_proof, get_merkle_proof_with_zero, get_merkle_root


@dataclass(frozen=True)
class BlockHeader:
    """8 fields (``block_header.rs:23-32``)."""

    block_number: int
    prev_block_hash: HashOut
    block_headers_digest: HashOut  # block header tree root
    transactions_digest: HashOut  # state diff tree root
    deposit_digest: HashOut  # deposit tree root (includes scroll root)
    proposed_world_state_digest: HashOut
    approved_world_state_digest: HashOut
    latest_account_digest: HashOut

    @classmethod
    def new(cls, log_num_txs_in_block: int) -> "BlockHeader":
        """Default header from zero-padded trees (``block_header.rs:127-154``)."""
        default_hash = HashOut.ZERO
        default_deposit_digest = get_merkle_proof_with_zero(
            [], 0, log_num_txs_in_block, default_hash
        ).root
        default_tx_hash = two_to_one(HashOut.ZERO, HashOut.ZERO)  # H(diff_root=0 || nonce=0)
        default_transactions_digest = get_merkle_proof_with_zero(
            [], 0, log_num_txs_in_block, default_tx_hash
        ).root
        default_block_headers_digest = get_merkle_proof([], 0, LOG_MAX_N_BLOCKS).root
        return cls(
            block_number=0,
            prev_block_hash=default_hash,
            block_headers_digest=default_block_headers_digest,
            transactions_digest=default_transactions_digest,
            deposit_digest=default_deposit_digest,
            proposed_world_state_digest=default_hash,
            approved_world_state_digest=default_hash,
            latest_account_digest=default_hash,
        )

    def to_json(self) -> dict:
        return {
            "block_number": "0x" + self.block_number.to_bytes(4, "big").hex(),
            "prev_block_hash": self.prev_block_hash.to_hex(),
            "block_headers_digest": self.block_headers_digest.to_hex(),
            "transactions_digest": self.transactions_digest.to_hex(),
            "deposit_digest": self.deposit_digest.to_hex(),
            "proposed_world_state_digest": self.proposed_world_state_digest.to_hex(),
            "approved_world_state_digest": self.approved_world_state_digest.to_hex(),
            "latest_account_digest": self.latest_account_digest.to_hex(),
        }

    @classmethod
    def from_json(cls, o: dict) -> "BlockHeader":
        bn = o["block_number"]
        assert bn.startswith("0x")
        return cls(
            block_number=int.from_bytes(bytes.fromhex(bn[2:]), "big"),
            prev_block_hash=HashOut.from_hex(o["prev_block_hash"]),
            block_headers_digest=HashOut.from_hex(o["block_headers_digest"]),
            transactions_digest=HashOut.from_hex(o["transactions_digest"]),
            deposit_digest=HashOut.from_hex(o["deposit_digest"]),
            proposed_world_state_digest=HashOut.from_hex(o["proposed_world_state_digest"]),
            approved_world_state_digest=HashOut.from_hex(o["approved_world_state_digest"]),
            latest_account_digest=HashOut.from_hex(o["latest_account_digest"]),
        )


def get_block_hash(h: BlockHeader) -> HashOut:
    """Fixed 6-hash Poseidon tree (``block_header.rs:157-174``)."""
    a = two_to_one(HashOut((h.block_number, 0, 0, 0)), h.latest_account_digest)
    b = two_to_one(h.deposit_digest, h.transactions_digest)
    c = two_to_one(a, b)
    d = two_to_one(h.proposed_world_state_digest, h.approved_world_state_digest)
    e = two_to_one(c, d)
    return two_to_one(h.block_headers_digest, e)


def get_block_header_tree_proof(
    block_hashes: list[HashOut], new_block_hash: HashOut, depth: int
):
    """``block_header.rs:176-186``: append-path siblings + old/new roots."""
    current_index = len(block_hashes)
    old_proof = get_merkle_proof(block_hashes, current_index, depth)
    new_root = get_merkle_root(current_index, new_block_hash, old_proof.siblings)
    return old_proof.siblings, old_proof.root, new_root
