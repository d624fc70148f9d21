"""Block-headers-tree append gadget (reference
``src/rollup/gadgets/block_headers_tree/mod.rs``): proves appending the
previous block hash at index ``prev_block_number`` in the depth-32 tree."""

from __future__ import annotations

from ....config import LOG_MAX_N_BLOCKS
from ....engine.circuit import CircuitBuilder, HashOutTarget
from ...merkle_tree.gadgets import MerkleProofTarget, get_merkle_root_target
from ...transaction.gadgets.block_header import BlockHeaderTarget, get_block_hash_target


def calc_block_headers_proof(
    builder: CircuitBuilder,
    prev_block_headers_proof_siblings: list[HashOutTarget],
    prev_block_header: BlockHeaderTarget,
) -> MerkleProofTarget:
    assert len(prev_block_headers_proof_siblings) == LOG_MAX_N_BLOCKS
    default_hash = builder.zero_hash()
    prev_block_number = prev_block_header.block_number

    # tree up to block_number-2 has a zero leaf at index block_number-1
    prev_digest = get_merkle_root_target(
        builder, prev_block_number, default_hash, prev_block_headers_proof_siblings
    )
    builder.connect_hashes(prev_digest, prev_block_header.block_headers_digest)

    prev_block_hash = get_block_hash_target(builder, prev_block_header)
    block_headers_digest = get_merkle_root_target(
        builder, prev_block_number, prev_block_hash, prev_block_headers_proof_siblings
    )
    return MerkleProofTarget(
        root=block_headers_digest,
        index=prev_block_number,
        value=prev_block_hash,
        siblings=prev_block_headers_proof_siblings,
    )
