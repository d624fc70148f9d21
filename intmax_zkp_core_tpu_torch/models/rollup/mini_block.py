"""CI-sized recursive block production — the flagship workload at the
smallest rollup shape, on one device.

One sender, one diff (amounts conserved), signed approval, inner user-tx
and signature proofs verified IN-CIRCUIT by the block circuit (reference
``rollup/circuits/mod.rs:450-489``).  Each group of inner proofs (the
user transaction and its default, the signature and its default) is one
``prove_batch`` call, bit-identical to a ``prove`` per witness.  Sharding
over a mesh of devices is not carried into this package yet.
"""

from __future__ import annotations

from ...config import LOG_MAX_N_BLOCKS, RollupConstants
from ...engine.config import CircuitConfig, FriConfig
from ...engine.prover import prove_batch
from ...engine.witness import PartialWitness
from ...utils.hash_out import HashOut
from ..merkle_tree.tree import get_merkle_proof
from ..sparse_merkle_tree import LayeredLayeredSparseMerkleTree, SparseMerkleTree
from ..sparse_merkle_tree.node_data import NodeDataMemory, RootDataTmp
from ..transaction.block_header import BlockHeader, get_block_hash
from ..transaction.circuits import (
    MergeAndPurgeTransitionPublicInputs,
    make_user_proof_circuit,
)
from ..transaction.user_asset_tree import UserAssetTree
from ..zkdsa.account import private_key_to_account
from ..zkdsa.circuits import make_simple_signature_circuit
from .circuits import BlockDetail, make_block_proof_circuit

MINI = RollupConstants(
    log_max_n_users=3,
    log_max_n_txs=3,
    log_max_n_contracts=3,
    log_max_n_variables=3,
    log_n_txs=2,  # >= 2: the witness-side deposit digest folds 3 bridge roots
    log_n_recipients=3,
    log_n_contracts=3,
    log_n_variables=3,
    n_registrations=1,
    n_diffs=1,
    n_merges=1,
    n_deposits=1,
    n_scroll_flags=1,
    n_polygon_flags=1,
    n_blocks=1,
)
MINI_CFG = CircuitConfig(fri=FriConfig(num_query_rounds=1, proof_of_work_bits=0))


def build_mini_circuits(constants=MINI, config=MINI_CFG, device=None):
    """(user, signature, recursive block) circuits for the mini flow on
    ``device`` (``None``: the CUDA device, raising without one)."""
    user_circuit = make_user_proof_circuit(constants, config, device)
    sig_circuit = make_simple_signature_circuit(config, device)
    block_circuit = make_block_proof_circuit(
        constants, user_circuit, sig_circuit, config, recursive=True, device=device
    )
    return user_circuit, sig_circuit, block_circuit


def run_mini_recursive_block(constants=MINI, config=MINI_CFG, circuits=None, device=None):
    """Build + prove the mini recursive block.  Returns a dict with the
    inner proofs, the block circuit, the ``BlockDetail`` and the verified
    block proof.  ``circuits``: reuse a ``build_mini_circuits`` result
    (built on the device the proofs are made on); otherwise they are built
    on ``device``."""
    if circuits is None:
        circuits = build_mini_circuits(constants, config, device)
    user_circuit, sig_circuit, block_circuit = circuits

    account = private_key_to_account(HashOut.from_u128(0xA11CE))
    nodes = NodeDataMemory()
    world_state_tree = SparseMerkleTree(NodeDataMemory(), RootDataTmp())
    asset_tree = UserAssetTree(nodes, RootDataTmp())
    diff_tree = LayeredLayeredSparseMerkleTree(nodes, RootDataTmp())

    merge_key = HashOut.from_u128(12)
    contract, variable = HashOut.from_u128(305), HashOut.from_u128(8012)
    recipient = HashOut.from_u128(407)
    amount = HashOut.from_u128(2053)

    asset_tree.set(merge_key, contract, variable, amount)
    world_state_tree.set(account.address.to_hash_out(), asset_tree.get_root())
    p_in = asset_tree.set(merge_key, contract, variable, HashOut.ZERO)
    p_out = diff_tree.set(recipient, contract, variable, amount)

    pw1 = PartialWitness()
    user_circuit.targets.set_witness(
        pw1, account.address, [], [p_in], [p_out],
        HashOut.from_u128(777), p_in[0].old_root,
    )
    pw2 = PartialWitness()
    user_circuit.targets.set_witness(
        pw2, type(account.address)(0), [], [], [], HashOut.ZERO, HashOut.ZERO
    )
    user_tx_proof, default_user_tx_proof = prove_batch(user_circuit.data, [pw1, pw2])

    prev_block_number = 1
    block_headers = [HashOut.ZERO]
    prev_header = BlockHeader(
        block_number=prev_block_number,
        prev_block_hash=HashOut.ZERO,
        block_headers_digest=get_merkle_proof(
            block_headers, prev_block_number - 1, LOG_MAX_N_BLOCKS
        ).root,
        transactions_digest=get_merkle_proof([], 0, constants.log_n_txs).root,
        deposit_digest=HashOut.ZERO,
        proposed_world_state_digest=world_state_tree.get_root(),
        approved_world_state_digest=world_state_tree.get_root(),
        latest_account_digest=HashOut.ZERO,
    )
    block_headers.append(get_block_hash(prev_header))

    user_pis = MergeAndPurgeTransitionPublicInputs.decode(user_tx_proof.public_inputs)
    ws_proof = world_state_tree.set(
        account.address.to_hash_out(), user_pis.new_user_asset_root
    )
    proposal_root = world_state_tree.get_root()

    pw1 = PartialWitness()
    sig_circuit.targets.set_witness(pw1, account.private_key, proposal_root)
    pw2 = PartialWitness()
    sig_circuit.targets.set_witness(pw2, HashOut.ZERO, HashOut.ZERO)
    signature_proof, default_signature_proof = prove_batch(sig_circuit.data, [pw1, pw2])

    block_number = prev_block_number + 1
    latest_account_tree = SparseMerkleTree(NodeDataMemory(), RootDataTmp())
    latest_account_proof = latest_account_tree.set(
        account.address.to_hash_out(), HashOut.from_u32(block_number)
    )
    revert_proof = world_state_tree.set(
        account.address.to_hash_out(), user_pis.new_user_asset_root
    )

    detail = BlockDetail(
        block_number=block_number,
        user_tx_proofs=[user_tx_proof],
        deposit_process_proofs=[],
        scroll_process_proofs=[],
        polygon_process_proofs=[],
        world_state_process_proofs=[ws_proof],
        world_state_revert_proofs=[revert_proof],
        received_signature_proofs=[signature_proof],
        latest_account_process_proofs=[latest_account_proof],
        block_headers_proof_siblings=get_merkle_proof(
            block_headers, prev_block_number, LOG_MAX_N_BLOCKS
        ).siblings,
        prev_block_header=prev_header,
    )

    block_proof = block_circuit.set_witness_and_prove(
        detail, default_user_tx_proof, default_signature_proof
    )
    block_circuit.verify(block_proof)
    return {
        "user_tx_proofs": [user_tx_proof, default_user_tx_proof],
        "signature_proofs": [signature_proof, default_signature_proof],
        "block_circuit": block_circuit,
        "detail": detail,
        "block_proof": block_proof,
    }
