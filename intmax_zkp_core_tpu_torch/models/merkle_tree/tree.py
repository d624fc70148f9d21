"""Dense Merkle tree with zero-padding (reference ``src/merkle_tree/tree.rs``).

Semantics preserved exactly:

* leaves are padded with `zero` up to the next power of two
  (``tree.rs:49-66``);
* `siblings` are ordered leaf->root, pre-filled with the zero-hash chain
  (``tree.rs:67-72``);
* above the filled prefix the sibling is *always on the right*
  (``tree.rs:85-91``) — the root folds `root = H(root, zero_chain[i])`;
* ``get_merkle_root(index, value, siblings)`` re-folds by index bits
  (``tree.rs:110-128``).
"""

from __future__ import annotations

from dataclasses import dataclass

from ...utils.hash_out import HashOut
from ...utils.poseidon_host import two_to_one


def log2_ceil(value: int) -> int:
    """``tree.rs:9-24``."""
    assert value > 0, "The first argument must be a positive number."
    return max(value - 1, 0).bit_length() if value > 1 else 0


@dataclass
class MerkleProof:
    index: int
    value: HashOut
    siblings: list[HashOut]
    root: HashOut

    @classmethod
    def new(cls, depth: int) -> "MerkleProof":
        return get_merkle_proof([HashOut.ZERO], 0, depth)

    def to_json(self) -> dict:
        return {
            "index": self.index,
            "value": self.value.to_hex(),
            "siblings": [s.to_hex() for s in self.siblings],
            "root": self.root.to_hex(),
        }

    @classmethod
    def from_json(cls, obj: dict) -> "MerkleProof":
        return cls(
            index=obj["index"],
            value=HashOut.from_hex(obj["value"]),
            siblings=[HashOut.from_hex(s) for s in obj["siblings"]],
            root=HashOut.from_hex(obj["root"]),
        )


def get_merkle_proof_with_zero(
    leaves: list[HashOut], index: int, depth: int, zero: HashOut
) -> MerkleProof:
    """``tree.rs:49-99``; asserts mirror the reference."""
    nodes = list(leaves) if leaves else [zero]
    assert index < len(nodes)
    assert len(nodes) <= 1 << depth
    num_leaves = 1 << log2_ceil(len(nodes))
    log_num_leaves = log2_ceil(num_leaves)
    value = nodes[index]
    nodes = nodes + [zero] * (num_leaves - len(nodes))

    # zero-hash chain, leaf level upward
    siblings = [zero]
    for _ in range(1, depth):
        last = siblings[-1]
        siblings.append(two_to_one(last, last))

    rest_index = index
    for level in range(log_num_leaves):
        siblings[level] = nodes[rest_index ^ 1]
        nodes = [two_to_one(nodes[2 * j], nodes[2 * j + 1]) for j in range(len(nodes) // 2)]
        rest_index >>= 1

    assert len(nodes) == 1
    root = nodes[0]
    for sibling in siblings[log_num_leaves:]:
        # above the filled prefix, sibling is always on the right
        root = two_to_one(root, sibling)

    return MerkleProof(index=index, value=value, siblings=siblings, root=root)


def get_merkle_proof(leaves: list[HashOut], index: int, depth: int) -> MerkleProof:
    return get_merkle_proof_with_zero(leaves, index, depth, HashOut.ZERO)


def get_merkle_root(index: int, value: HashOut, siblings: list[HashOut]) -> HashOut:
    """``tree.rs:110-128``."""
    root = value
    rest_index = index
    for sibling in siblings:
        if rest_index & 1 == 0:
            root = two_to_one(root, sibling)
        else:
            root = two_to_one(sibling, root)
        rest_index >>= 1
    return root
