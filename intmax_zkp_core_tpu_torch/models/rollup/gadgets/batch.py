"""Block-batch gadget (reference ``src/rollup/gadgets/batch/mod.rs``):
wraps n_blocks recursive block proofs, padding unused slots with the last
proof (disabled)."""

from __future__ import annotations

from dataclasses import dataclass

from ....engine.circuit import CircuitBuilder
from ...recursion.gadgets import RecursiveProofTarget


@dataclass
class BlockBatchTarget:
    block_proofs: list[RecursiveProofTarget]

    @classmethod
    def add_virtual_to(
        cls, builder: CircuitBuilder, block_circuit_data, n_blocks: int
    ) -> "BlockBatchTarget":
        return cls(
            block_proofs=[
                RecursiveProofTarget.add_virtual_to(builder, block_circuit_data)
                for _ in range(n_blocks)
            ]
        )

    def set_witness(self, pw, block_proofs: list) -> None:
        assert block_proofs, "at least one block proof required"
        assert len(block_proofs) <= len(self.block_proofs)
        for t, p in zip(self.block_proofs, block_proofs):
            t.set_witness(pw, p, True)
        for t in self.block_proofs[len(block_proofs):]:
            t.set_witness(pw, block_proofs[-1], False)
