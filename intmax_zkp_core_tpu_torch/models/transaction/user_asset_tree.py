"""UserAssetTree: 3-level SMT keyed (merge_key, contract_address,
variable_index) whose top-layer leaf value is ``hash(asset_root, merge_key)``
stored as an explicit Internal node (reference
``src/transaction/tree/user_asset.rs:37-244``)."""

from __future__ import annotations

from ...utils.hash_out import HashOut
from ..sparse_merkle_tree.node_data import Node, NodeDataMemory, RootDataMemory, calc_node_hash
from ..sparse_merkle_tree.tree import ZERO, calc_inclusion_proof, calc_process_proof, get


class UserAssetTree:
    def __init__(self, nodes_db=None, roots_db=None):
        self.nodes_db = nodes_db if nodes_db is not None else NodeDataMemory()
        self.roots_db = roots_db if roots_db is not None else RootDataMemory()

    def get_root(self) -> HashOut:
        return self.roots_db.get()

    def change_root(self, root_hash: HashOut) -> None:
        if root_hash != ZERO and self.nodes_db.get(root_hash) is None:
            raise KeyError("the node corresponding `root_hash` does not exist")
        self.roots_db.set(root_hash)

    def _unwrap_asset_root(self, asset_root_with_merge: HashOut, merge_key: HashOut) -> HashOut:
        """The value stored at merge_key level is hash(Internal(asset_root,
        merge_key)); its children node gives back the asset root
        (``user_asset.rs:110-134, 212-243``)."""
        children = self.nodes_db.get(asset_root_with_merge)
        if children is None or children.is_leaf:
            raise KeyError("searching node is not found")
        asset_root, found_merge_key = children.a, children.b
        if found_merge_key != merge_key:
            raise AssertionError("fatal error: merge key is invalid")
        return asset_root

    def set(
        self,
        merge_key: HashOut,
        contract_address: HashOut,
        variable_index: HashOut,
        amount: HashOut,
    ):
        """``user_asset.rs:99-161``.  Zero amount deletes."""
        layer0_root = self.get_root()
        asset_root_with_merge = get(self.nodes_db, layer0_root, merge_key)
        if asset_root_with_merge == ZERO:
            layer1_root = ZERO
        else:
            layer1_root = self._unwrap_asset_root(asset_root_with_merge, merge_key)

        layer2_root = get(self.nodes_db, layer1_root, contract_address)
        layer2_root, result2 = calc_process_proof(
            self.nodes_db, layer2_root, variable_index, amount
        )
        layer1_root, result1 = calc_process_proof(
            self.nodes_db, layer1_root, contract_address, layer2_root
        )

        layer0_children = Node.internal(layer1_root, merge_key)
        asset_root = calc_node_hash(layer0_children)
        self.nodes_db.multi_insert([(asset_root, layer0_children)])

        layer0_root, result0 = calc_process_proof(
            self.nodes_db, layer0_root, merge_key, asset_root
        )
        self.roots_db.set(layer0_root)
        return result0, result1, result2

    def find(self, merge_key: HashOut, contract_address: HashOut, variable_index: HashOut):
        """``user_asset.rs:163-210``."""
        layer0_root = self.get_root()
        result0 = calc_inclusion_proof(self.nodes_db, layer0_root, merge_key)
        if result0.found:
            layer1_root = self._unwrap_asset_root(result0.value, merge_key)
        else:
            layer1_root = ZERO
        result1 = calc_inclusion_proof(self.nodes_db, layer1_root, contract_address)
        layer2_root = result1.value if result1.found else ZERO
        result2 = calc_inclusion_proof(self.nodes_db, layer2_root, variable_index)
        return result0, result1, result2

    def get_asset_root(self, merge_key: HashOut) -> HashOut:
        """``user_asset.rs:212-243``."""
        layer0_root = self.get_root()
        result0 = calc_inclusion_proof(self.nodes_db, layer0_root, merge_key)
        if not result0.found:
            return ZERO
        return self._unwrap_asset_root(result0.value, merge_key)
