"""Core keyed sparse Merkle tree, circomlib-style (reference
``src/sparse_merkle_tree/tree.rs``).

Semantics preserved exactly:

* keys walk the tree along the LE bit path of their digest;
* ``set(key, value)`` dispatches insert/update/remove/noop by (found,
  value==0) (``tree.rs:561-586``); zero value means deletion;
* each op emits a ``SparseMerkleProcessProof`` with circomlib field
  conventions (remove swaps old/new relative to circomlib's original,
  ``tree.rs:389-402`` comment);
* node DB keeps deleted nodes so any historical root stays readable, and
  ``change_root`` rolls the tree back/forward to any stored root
  (``tree.rs:77-94``).
"""

from __future__ import annotations

from ...utils.hash_out import HashOut
from .node_data import Node, NodeDataMemory, RootDataMemory, calc_node_hash
from .proofs import (
    ProcessMerkleProofRole,
    SparseMerkleInclusionProof,
    SparseMerkleProcessProof,
    key_to_bits_256,
)

ZERO = HashOut.ZERO


def key_to_bits(key: HashOut) -> list[bool]:
    return key_to_bits_256(key)


# --- free functions operating on (nodes_db, root), shared with the layered
#     trees (tree.rs:176-705) ---


def find(nodes_db, root: HashOut, key: HashOut) -> SparseMerkleInclusionProof:
    """Walk root->leaf along the key's bit path (``tree.rs:588-676``)."""
    key_bits = key_to_bits_256(key)
    siblings: list[HashOut] = []
    node_hash = root
    level = 0
    while True:
        if node_hash == ZERO:
            return SparseMerkleInclusionProof(
                root=root, found=False, siblings=siblings, key=key, value=ZERO,
                not_found_key=ZERO, not_found_value=ZERO, is_old0=True,
            )
        node = nodes_db.get(node_hash)
        if node is None:
            raise KeyError("searching node is not found")
        if node.is_leaf:
            record_key, record_value = node.a, node.b
            if record_key == key:
                return SparseMerkleInclusionProof(
                    root=root, found=True, siblings=siblings, key=key, value=record_value,
                    not_found_key=ZERO, not_found_value=ZERO, is_old0=False,
                )
            return SparseMerkleInclusionProof(
                root=root, found=False, siblings=siblings, key=key, value=ZERO,
                not_found_key=record_key, not_found_value=record_value, is_old0=False,
            )
        left, right = node.a, node.b
        if key_bits[level]:
            siblings.append(left)
            node_hash = right
        else:
            siblings.append(right)
            node_hash = left
        level += 1


def get(nodes_db, root: HashOut, key: HashOut) -> HashOut:
    res = find(nodes_db, root, key)
    return res.value if res.found else ZERO


def _update(nodes_db, root: HashOut, key: HashOut, new_value: HashOut):
    """``tree.rs:173-254``."""
    res_find = find(nodes_db, root, key)
    if not res_find.found:
        raise ValueError("given key does not exists")
    if new_value == ZERO:
        raise ValueError("value must be non-zero")
    assert res_find.key == key

    found_key, found_value = res_find.key, res_find.value
    old_root = res_find.root

    inserts, deletes = [], []
    old_leaf = Node.leaf(found_key, found_value)
    new_leaf = Node.leaf(found_key, new_value)
    rt_old = calc_node_hash(old_leaf)
    rt_new = calc_node_hash(new_leaf)
    inserts.append((rt_new, new_leaf))
    deletes.append(rt_old)

    key_bits = key_to_bits_256(found_key)
    for sibling, bit in reversed(list(zip(res_find.siblings, key_bits))):
        if bit:
            old_node = Node.internal(sibling, rt_old)
            new_node = Node.internal(sibling, rt_new)
        else:
            old_node = Node.internal(rt_old, sibling)
            new_node = Node.internal(rt_new, sibling)
        rt_old = calc_node_hash(old_node)
        rt_new = calc_node_hash(new_node)
        deletes.append(rt_old)
        inserts.append((rt_new, new_node))

    nodes_db.multi_delete(deletes)
    nodes_db.multi_insert(inserts)

    proof = SparseMerkleProcessProof(
        old_root=old_root, old_key=found_key, old_value=found_value,
        new_root=rt_new, new_key=found_key, new_value=new_value,
        siblings=res_find.siblings, is_old0=False,
        fnc=ProcessMerkleProofRole.ProcessUpdate,
    )
    return rt_new, proof


def _insert(nodes_db, root: HashOut, key: HashOut, value: HashOut):
    """``tree.rs:255-387``."""
    res_find = find(nodes_db, root, key)
    old_root = res_find.root
    if res_find.found:
        raise ValueError("given key already exists")
    if value == ZERO:
        raise ValueError("value must be non-zero")

    siblings = list(res_find.siblings)
    not_found_key = res_find.not_found_key
    not_found_value = res_find.not_found_value

    if not res_find.is_old0:
        # the search stopped at a different leaf: push zero siblings for the
        # shared bit-path prefix below the current level, then the old leaf
        old_bits = key_to_bits_256(not_found_key)
        new_bits = key_to_bits_256(key)
        for ob, nb in list(zip(old_bits, new_bits))[len(siblings):]:
            if ob != nb:
                break
            siblings.append(ZERO)
        rt_old = calc_node_hash(Node.leaf(not_found_key, not_found_value))
        siblings.append(rt_old)
        added_one = True
        mixed = False
    else:
        mixed = bool(siblings)
        added_one = False
        rt_old = ZERO

    inserts, deletes = [], []
    new_leaf = Node.leaf(key, value)
    rt = calc_node_hash(new_leaf)
    inserts.append((rt, new_leaf))

    new_bits = key_to_bits_256(key)
    for level, (sibling, bit) in enumerate(reversed(list(zip(siblings, new_bits)))):
        if level != 0 and sibling != ZERO:
            mixed = True

        if mixed:
            old_node = Node.internal(sibling, rt_old) if bit else Node.internal(rt_old, sibling)
            rt_old = calc_node_hash(old_node)
            deletes.append(rt_old)

        new_node = Node.internal(sibling, rt) if bit else Node.internal(rt, sibling)
        new_rt = calc_node_hash(new_node)
        inserts.append((new_rt, new_node))
        rt = new_rt

    if added_one:
        siblings.pop()
    while siblings and siblings[-1] == ZERO:
        siblings.pop()

    nodes_db.multi_delete(deletes)
    nodes_db.multi_insert(inserts)

    proof = SparseMerkleProcessProof(
        old_root=old_root, old_key=not_found_key, old_value=not_found_value,
        new_root=rt, new_key=key, new_value=value,
        siblings=siblings, is_old0=res_find.is_old0,
        fnc=ProcessMerkleProofRole.ProcessInsert,
    )
    return rt, proof


def _remove(nodes_db, root: HashOut, key: HashOut):
    """``tree.rs:390-533``.  NB: emits (old,new) swapped vs circomlib's
    original so the proof reads as a natural old->new transition."""
    res_find = find(nodes_db, root, key)
    if not res_find.found:
        raise ValueError("given key does not exists")
    assert res_find.key == key

    found_key, found_value = res_find.key, res_find.value

    deletes, inserts = [], []
    rt_old = calc_node_hash(Node.leaf(found_key, found_value))
    deletes.append(rt_old)

    if res_find.siblings:
        last_sibling = res_find.siblings[-1]
        next_node = nodes_db.get(last_sibling)
        if next_node is None:
            raise KeyError("sibling node is not found")
        if next_node.is_leaf:
            mixed = False
            res_old_key, res_old_value = next_node.a, next_node.b
            res_is_old0 = False
            rt_new = last_sibling
        else:
            mixed = True
            res_old_key = found_key
            res_old_value = ZERO
            res_is_old0 = True
            rt_new = ZERO
    else:
        mixed = False
        res_old_key = found_key
        res_old_value = ZERO
        res_is_old0 = True
        rt_new = ZERO

    key_bits = key_to_bits_256(found_key)
    res_siblings: list[HashOut] = []
    for level, (sibling, bit) in enumerate(reversed(list(zip(res_find.siblings, key_bits)))):
        new_sibling = ZERO if (level == 0 and not res_is_old0) else sibling
        old_sibling = sibling
        old_node = Node.internal(old_sibling, rt_old) if bit else Node.internal(rt_old, old_sibling)
        rt_old = calc_node_hash(old_node)
        deletes.append(rt_old)

        if new_sibling != ZERO:
            mixed = True

        if mixed:
            res_siblings.insert(0, sibling)
            new_node = (
                Node.internal(new_sibling, rt_new) if bit else Node.internal(rt_new, new_sibling)
            )
            rt_new = calc_node_hash(new_node)
            inserts.append((rt_new, new_node))

    nodes_db.multi_delete(deletes)
    nodes_db.multi_insert(inserts)

    proof = SparseMerkleProcessProof(
        old_root=rt_old, old_key=found_key, old_value=found_value,
        new_root=rt_new, new_key=res_old_key, new_value=res_old_value,
        siblings=res_siblings, is_old0=res_is_old0,
        fnc=ProcessMerkleProofRole.ProcessDelete,
    )
    return rt_new, proof


def _noop(root: HashOut, key: HashOut):
    """``tree.rs:535-559``."""
    proof = SparseMerkleProcessProof(
        old_root=root, old_key=key, old_value=ZERO,
        new_root=root, new_key=key, new_value=ZERO,
        siblings=[], is_old0=True,
        fnc=ProcessMerkleProofRole.ProcessNoOp,
    )
    return root, proof


def calc_process_proof(nodes_db, root: HashOut, key: HashOut, value: HashOut):
    """Dispatch by (found, zero-value) (``tree.rs:561-586``).
    Returns (new_root, proof)."""
    res_find = find(nodes_db, root, key)
    if value == ZERO:
        if res_find.found:
            return _remove(nodes_db, root, key)
        return _noop(root, key)
    if res_find.found:
        return _update(nodes_db, root, key, value)
    return _insert(nodes_db, root, key, value)


def calc_inclusion_proof(nodes_db, root: HashOut, key: HashOut) -> SparseMerkleInclusionProof:
    return find(nodes_db, root, key)


class SparseMerkleTree:
    """Stateful wrapper binding a node DB and a root store
    (``tree.rs:10-174``)."""

    def __init__(self, nodes_db=None, roots_db=None):
        self.nodes_db = nodes_db if nodes_db is not None else NodeDataMemory()
        self.roots_db = roots_db if roots_db is not None else RootDataMemory()

    def get_root(self) -> HashOut:
        return self.roots_db.get()

    def change_root(self, root_hash: HashOut) -> None:
        """Roll state to any historical root (``tree.rs:77-94``) — the
        checkpoint/resume primitive."""
        if root_hash != ZERO and self.nodes_db.get(root_hash) is None:
            raise KeyError("the node corresponding `root_hash` does not exist")
        self.roots_db.set(root_hash)

    def set(self, key: HashOut, value: HashOut) -> SparseMerkleProcessProof:
        root, proof = calc_process_proof(self.nodes_db, self.get_root(), key, value)
        self.roots_db.set(root)
        return proof

    def insert(self, key: HashOut, value: HashOut) -> SparseMerkleProcessProof:
        root, proof = _insert(self.nodes_db, self.get_root(), key, value)
        self.roots_db.set(root)
        return proof

    def update(self, key: HashOut, value: HashOut) -> SparseMerkleProcessProof:
        root, proof = _update(self.nodes_db, self.get_root(), key, value)
        self.roots_db.set(root)
        return proof

    def remove(self, key: HashOut) -> SparseMerkleProcessProof:
        root, proof = _remove(self.nodes_db, self.get_root(), key)
        self.roots_db.set(root)
        return proof

    def find(self, key: HashOut) -> SparseMerkleInclusionProof:
        return find(self.nodes_db, self.get_root(), key)

    def get(self, key: HashOut) -> HashOut:
        return get(self.nodes_db, self.get_root(), key)
