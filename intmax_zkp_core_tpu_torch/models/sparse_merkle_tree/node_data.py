"""SMT node/root storage (reference ``src/sparse_merkle_tree/node_data.rs``,
``root_data.rs``, and the in-memory impls at
``goldilocks_poseidon/mod.rs:58-156``)."""

from __future__ import annotations

from dataclasses import dataclass, field

from ...utils.hash_out import HashOut
from ...utils.poseidon_host import hash_pad, two_to_one


@dataclass(frozen=True)
class Node:
    """Either an internal node (left, right child digests) or a leaf
    (key, value).  ``kind`` is 'internal' or 'leaf'."""

    kind: str
    a: HashOut
    b: HashOut

    @classmethod
    def internal(cls, left: HashOut, right: HashOut) -> "Node":
        return cls("internal", left, right)

    @classmethod
    def leaf(cls, key: HashOut, value: HashOut) -> "Node":
        return cls("leaf", key, value)

    @property
    def is_leaf(self) -> bool:
        return self.kind == "leaf"


def calc_node_hash(node: Node) -> HashOut:
    """PoseidonNodeHash (reference ``goldilocks_poseidon/mod.rs:158-184``):
    internal = two_to_one(left, right); leaf = hash_pad(key || value || 1)
    — the trailing 1 domain-separates leaves from internal nodes."""
    if node.is_leaf:
        return hash_pad(list(node.a.elements) + list(node.b.elements) + [1])
    return two_to_one(node.a, node.b)


class NodeDataMemory:
    """dict-backed node store.  Deletes are deliberate no-ops so historical
    roots stay resolvable (reference ``goldilocks_poseidon/mod.rs:86-93``) —
    this is the framework's checkpoint/rollback substrate together with
    ``RootDataMemory`` and ``change_root``."""

    def __init__(self):
        self.nodes: dict[HashOut, Node] = {}

    def get(self, key: HashOut) -> Node | None:
        return self.nodes.get(key)

    def multi_get(self, keys) -> list[Node | None]:
        return [self.get(k) for k in keys]

    def multi_insert(self, entries) -> None:
        for key, node in entries:
            self.nodes[key] = node

    def multi_delete(self, keys) -> None:
        # intentionally keep deleted nodes (history stays readable)
        pass


@dataclass
class RootDataMemory:
    """Append-only root history; ``get`` returns the latest
    (``goldilocks_poseidon/mod.rs:96-133``)."""

    roots: list[HashOut] = field(default_factory=lambda: [HashOut.ZERO])

    def get(self) -> HashOut:
        return self.roots[-1]

    def set(self, root: HashOut) -> None:
        self.roots.append(root)


@dataclass
class RootDataTmp:
    """Single mutable root (``goldilocks_poseidon/mod.rs:136-156``)."""

    root: HashOut = HashOut.ZERO

    def get(self) -> HashOut:
        return self.root

    def set(self, root: HashOut) -> None:
        self.root = root
