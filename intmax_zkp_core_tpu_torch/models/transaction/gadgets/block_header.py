"""Block-header target + in-circuit block hash (reference
``src/transaction/gadgets/block_header/mod.rs``)."""

from __future__ import annotations

from dataclasses import dataclass

from ....config import LOG_MAX_N_BLOCKS
from ....engine.circuit import CircuitBuilder, HashOutTarget
from ....utils.hash_out import HashOut
from ..block_header import BlockHeader
from ...sparse_merkle_tree.gadgets.common import poseidon_two_to_one


@dataclass
class BlockHeaderTarget:
    block_number: int  # target (u32, range-checked)
    block_headers_digest: HashOutTarget
    transactions_digest: HashOutTarget
    deposit_digest: HashOutTarget
    proposed_world_state_digest: HashOutTarget
    approved_world_state_digest: HashOutTarget
    latest_account_digest: HashOutTarget

    @classmethod
    def add_virtual_to(cls, builder: CircuitBuilder) -> "BlockHeaderTarget":
        block_number = builder.add_virtual_target()
        builder.range_check(block_number, LOG_MAX_N_BLOCKS)
        return cls(
            block_number=block_number,
            block_headers_digest=builder.add_virtual_hash(),
            transactions_digest=builder.add_virtual_hash(),
            deposit_digest=builder.add_virtual_hash(),
            proposed_world_state_digest=builder.add_virtual_hash(),
            approved_world_state_digest=builder.add_virtual_hash(),
            latest_account_digest=builder.add_virtual_hash(),
        )

    def set_witness(self, pw, header: BlockHeader) -> None:
        pw.set_target(self.block_number, header.block_number)
        pw.set_hash_target(self.block_headers_digest, header.block_headers_digest)
        pw.set_hash_target(self.transactions_digest, header.transactions_digest)
        pw.set_hash_target(self.deposit_digest, header.deposit_digest)
        pw.set_hash_target(self.proposed_world_state_digest, header.proposed_world_state_digest)
        pw.set_hash_target(self.approved_world_state_digest, header.approved_world_state_digest)
        pw.set_hash_target(self.latest_account_digest, header.latest_account_digest)


def hash_out_target_from_partial(builder: CircuitBuilder, elements: list[int]) -> HashOutTarget:
    zero = builder.zero()
    elems = list(elements) + [zero] * (4 - len(elements))
    return HashOutTarget(tuple(elems))


def get_block_hash_target(builder: CircuitBuilder, h: BlockHeaderTarget) -> HashOutTarget:
    """Same 6-hash shape as the host ``get_block_hash``
    (``block_header/mod.rs:74-101``)."""
    bn = hash_out_target_from_partial(builder, [h.block_number])
    a = poseidon_two_to_one(builder, bn, h.latest_account_digest)
    b = poseidon_two_to_one(builder, h.deposit_digest, h.transactions_digest)
    c = poseidon_two_to_one(builder, a, b)
    d = poseidon_two_to_one(
        builder, h.proposed_world_state_digest, h.approved_world_state_digest
    )
    e = poseidon_two_to_one(builder, c, d)
    return poseidon_two_to_one(builder, h.block_headers_digest, e)
