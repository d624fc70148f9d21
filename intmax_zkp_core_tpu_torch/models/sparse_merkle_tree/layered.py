"""Layered (2- and 3-level) SMTs sharing one node DB (reference
``src/sparse_merkle_tree/layered_tree.rs`` and
``layered_layered_tree.rs``)."""

from __future__ import annotations

from ...utils.hash_out import HashOut
from .node_data import NodeDataMemory, RootDataMemory
from .proofs import ProcessMerkleProofRole
from .tree import ZERO, calc_inclusion_proof, calc_process_proof, find, get


class LayeredSparseMerkleTree:
    """SMT of SMTs: the inner tree's root is stored as the outer tree's
    value (``layered_tree.rs:131-155``).  Zero value deletes."""

    def __init__(self, nodes_db=None, roots_db=None):
        self.nodes_db = nodes_db if nodes_db is not None else NodeDataMemory()
        self.roots_db = roots_db if roots_db is not None else RootDataMemory()

    def get_root(self) -> HashOut:
        return self.roots_db.get()

    def change_root(self, root_hash: HashOut) -> None:
        if root_hash != ZERO and self.nodes_db.get(root_hash) is None:
            raise KeyError("the node corresponding `root_hash` does not exist")
        self.roots_db.set(root_hash)

    def set(self, key1: HashOut, key2: HashOut, value: HashOut):
        layer1_root = self.get_root()
        layer2_root = get(self.nodes_db, layer1_root, key1)
        layer2_root, result2 = calc_process_proof(self.nodes_db, layer2_root, key2, value)
        layer1_root, result1 = calc_process_proof(self.nodes_db, layer1_root, key1, layer2_root)
        self.roots_db.set(layer1_root)
        return result1, result2

    def find(self, key1: HashOut, key2: HashOut):
        layer1_root = self.get_root()
        result1 = calc_inclusion_proof(self.nodes_db, layer1_root, key1)
        layer2_root = result1.value if result1.found else ZERO
        result2 = calc_inclusion_proof(self.nodes_db, layer2_root, key2)
        return result1, result2


class LayeredLayeredSparseMerkleTree:
    """3-level variant (``layered_layered_tree.rs:26-196``), used for
    deposit / tx-diff trees (recipient -> contract -> variable index)."""

    def __init__(self, nodes_db=None, roots_db=None):
        self.nodes_db = nodes_db if nodes_db is not None else NodeDataMemory()
        self.roots_db = roots_db if roots_db is not None else RootDataMemory()

    def get_root(self) -> HashOut:
        return self.roots_db.get()

    def change_root(self, root_hash: HashOut) -> None:
        if root_hash != ZERO and self.nodes_db.get(root_hash) is None:
            raise KeyError("the node corresponding `root_hash` does not exist")
        self.roots_db.set(root_hash)

    def set(self, key1: HashOut, key2: HashOut, key3: HashOut, value: HashOut):
        layer1_root = self.get_root()
        layer2_root = get(self.nodes_db, layer1_root, key1)
        layer3_root = get(self.nodes_db, layer2_root, key2)
        layer3_root, result3 = calc_process_proof(self.nodes_db, layer3_root, key3, value)
        layer2_root, result2 = calc_process_proof(self.nodes_db, layer2_root, key2, layer3_root)
        layer1_root, result1 = calc_process_proof(self.nodes_db, layer1_root, key1, layer2_root)
        self.roots_db.set(layer1_root)
        return result1, result2, result3

    def find(self, key1: HashOut, key2: HashOut, key3: HashOut):
        layer1_root = self.get_root()
        result1 = calc_inclusion_proof(self.nodes_db, layer1_root, key1)
        layer2_root = result1.value if result1.found else ZERO
        result2 = calc_inclusion_proof(self.nodes_db, layer2_root, key2)
        layer3_root = result2.value if result2.found else ZERO
        result3 = calc_inclusion_proof(self.nodes_db, layer3_root, key3)
        return result1, result2, result3


def verify_layered_smt_connection(
    upper_smt_fnc: ProcessMerkleProofRole,
    old_upper_smt_value: HashOut,
    new_upper_smt_value: HashOut,
    old_lower_smt_root: HashOut,
    new_lower_smt_root: HashOut,
) -> None:
    """Upper-value vs lower-root consistency per op
    (``layered_tree.rs:178-233``)."""
    R = ProcessMerkleProofRole
    if upper_smt_fnc == R.ProcessUpdate:
        if old_lower_smt_root != old_upper_smt_value:
            raise AssertionError("update: old_lower_smt_root != old_upper_smt_value")
        if new_lower_smt_root != new_upper_smt_value:
            raise AssertionError("update: new_lower_smt_root != new_upper_smt_value")
    elif upper_smt_fnc == R.ProcessInsert:
        if old_lower_smt_root != ZERO:
            raise AssertionError("insert: old_lower_smt_root must be zero")
        if new_lower_smt_root != new_upper_smt_value:
            raise AssertionError("insert: new_lower_smt_root != new_upper_smt_value")
    elif upper_smt_fnc == R.ProcessDelete:
        if old_lower_smt_root != old_upper_smt_value:
            raise AssertionError("delete: old_lower_smt_root != old_upper_smt_value")
        if new_lower_smt_root != ZERO:
            raise AssertionError("delete: new_lower_smt_root must be zero")
    else:  # noop
        if old_lower_smt_root != ZERO:
            raise AssertionError("noop: old_lower_smt_root must be zero")
        if new_lower_smt_root != ZERO:
            raise AssertionError("noop: new_lower_smt_root must be zero")
