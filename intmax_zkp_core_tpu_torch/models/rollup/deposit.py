"""Deposit proof helper (reference ``src/rollup/deposit.rs:46-135``):
builds the 3 bridge trees out-of-circuit, combines their roots as
``Poseidon(inner_root || chain_index)`` for chain indices 0/1/2, and returns
dense-Merkle + SMT inclusion proof pairs for a receiver."""

from __future__ import annotations

from ...utils.hash_out import HashOut
from ...utils.poseidon_host import two_to_one
from ..merkle_tree.tree import get_merkle_proof
from ..sparse_merkle_tree.layered import LayeredLayeredSparseMerkleTree
from ..sparse_merkle_tree.tree import calc_inclusion_proof
from ..zkdsa.account import Address
from .gadgets.deposit_block import DepositInfo


def _build_bridge_tree(deposit_list: list[DepositInfo]) -> LayeredLayeredSparseMerkleTree:
    tree = LayeredLayeredSparseMerkleTree()
    for leaf in deposit_list:
        tree.set(
            leaf.receiver_address.to_hash_out(),
            leaf.contract_address.to_hash_out(),
            leaf.variable_index.to_hash_out(),
            HashOut((leaf.amount, 0, 0, 0)),
        )
    return tree


def make_deposit_proof(
    deposit_list: list[DepositInfo],
    scroll_flag_list: list[DepositInfo],
    polygon_flag_list: list[DepositInfo],
    receiver_address: Address,
    num_log_txs: int,
):
    trees = [
        _build_bridge_tree(deposit_list),
        _build_bridge_tree(scroll_flag_list),
        _build_bridge_tree(polygon_flag_list),
    ]
    roots = [
        two_to_one(tree.get_root(), HashOut((chain_index, 0, 0, 0)))
        for chain_index, tree in enumerate(trees)
    ]
    out = []
    for chain_index, tree in enumerate(trees):
        proof1 = get_merkle_proof(roots, chain_index, num_log_txs)
        proof2 = calc_inclusion_proof(
            tree.nodes_db, tree.get_root(), receiver_address.to_hash_out()
        )
        out.append((proof1, proof2))
    return out
