"""Dense-Merkle in-circuit gadgets (reference ``src/merkle_tree/gadgets/mod.rs``)."""

from __future__ import annotations

from dataclasses import dataclass

from ...engine.circuit import CircuitBuilder, HashOutTarget
from ...utils.hash_out import HashOut
from ..merkle_tree.tree import get_merkle_root
from ..sparse_merkle_tree.gadgets.common import poseidon_two_to_one


def get_merkle_root_target(
    builder: CircuitBuilder, index_t: int, value_t: HashOutTarget, siblings_t: list[HashOutTarget]
) -> HashOutTarget:
    """Root from (index bits, value, siblings) with per-level swap
    (``gadgets/mod.rs:70-88``); uses the Poseidon gate's swap wire."""
    root_t = value_t
    bits = builder.split_le(index_t, len(siblings_t))
    for sibling_t, lr_bit in zip(siblings_t, bits):
        root_t = builder.two_to_one_swapped(root_t, sibling_t, lr_bit)
    return root_t


def get_merkle_root_target_from_leaves(
    builder: CircuitBuilder, leaves_t: list[HashOutTarget]
) -> HashOutTarget:
    """Root reduction over all leaves (``gadgets/mod.rs:90-111``)."""
    layer = list(leaves_t)
    assert layer
    while len(layer) > 1:
        if len(layer) % 2 == 1:
            layer.append(layer[-1])
        layer = [
            poseidon_two_to_one(builder, layer[2 * i], layer[2 * i + 1])
            for i in range(len(layer) // 2)
        ]
    return layer[0]


@dataclass
class MerkleProofTarget:
    """``gadgets/mod.rs:17-68``."""

    index: int  # target
    value: HashOutTarget
    siblings: list[HashOutTarget]
    root: HashOutTarget

    @classmethod
    def add_virtual_to(cls, builder: CircuitBuilder, n_levels: int) -> "MerkleProofTarget":
        index = builder.add_virtual_target()
        builder.range_check(index, n_levels)
        value = builder.add_virtual_hash()
        siblings = builder.add_virtual_hashes(n_levels)
        root = get_merkle_root_target(builder, index, value, siblings)
        return cls(index=index, value=value, siblings=siblings, root=root)

    def set_witness(self, pw, index: int, value: HashOut, siblings: list[HashOut]) -> HashOut:
        pw.set_target(self.index, index)
        pw.set_hash_target(self.value, value)
        assert len(self.siblings) == len(siblings)
        for t, s in zip(self.siblings, siblings):
            pw.set_hash_target(t, s)
        return get_merkle_root(index, value, siblings)
