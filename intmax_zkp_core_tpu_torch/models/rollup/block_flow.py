"""End-to-end block production flow -- the counterpart of the reference's
flagship binary (``src/bin/block_circuit.rs:48-663``) -- its first stages.

``prove_user_txs_and_signatures`` runs the flow from building the
user-transaction circuit through proving the signatures: two senders (one
transfer-only, one merging a deposit made in the previous block) and a
default transaction, proved as one batch; the proposal's world state; the
second sender's signature of it and a default signature, proved as a second
batch (``prove_batch``; the JAX flow's device rule, a batch on an
accelerator and a loop of single proofs on the CPU, has nothing to choose
here: ``prove`` is ``prove_batch`` at K = 1).  It returns the circuits, the five proofs and the
state the later stages read.  ``run_block_flow`` (the block circuit, its
witness and ``BlockInfo``) is to call it first; those stages wait for the
rollup circuits and the recursion gadgets.
"""

from __future__ import annotations

from dataclasses import dataclass

from ...config import LOG_MAX_N_BLOCKS, RollupConstants
from ...engine.config import CircuitConfig
from ...engine.prover import PhaseTimer, prove_batch
from ...engine.witness import PartialWitness
from ...ops import goldilocks as gl
from ...utils.hash_out import HashOut
from ...utils.poseidon_host import two_to_one
from ..merkle_tree.tree import get_merkle_proof
from ..sparse_merkle_tree import (
    LayeredLayeredSparseMerkleTree,
    SparseMerkleInclusionProof,
    SparseMerkleTree,
)
from ..sparse_merkle_tree.node_data import NodeDataMemory, RootDataTmp
from ..sparse_merkle_tree.tree import calc_inclusion_proof
from ..transaction.block_header import BlockHeader, get_block_hash
from ..transaction.circuits import make_user_proof_circuit
from ..transaction.gadgets.merge import MergeProof
from ..transaction.user_asset_tree import UserAssetTree
from ..zkdsa.account import Address, private_key_to_account
from ..zkdsa.circuits import make_simple_signature_circuit


@dataclass
class UserTxStages:
    """What the flow's stages up to ``prove_signatures`` give the later ones."""

    user_tx_circuit: object
    zkdsa_circuit: object
    user_tx_witnesses: list  # PartialWitness: sender 1, sender 2, the default transaction
    user_tx_public_inputs: list  # the MergeAndPurgeTransitionPublicInputs each must give
    user_tx_nonces: list  # HashOut per transaction
    user_tx_proofs: list
    signature_witnesses: list  # sender 2's signature of the proposal, the default one
    signature_proofs: list
    aggregator_nodes: NodeDataMemory
    world_state_tree: SparseMerkleTree
    world_state_process_proofs: list  # the proposal's two world-state updates
    proposal_world_state_root: HashOut
    sender_accounts: list
    sender_user_asset_trees: list
    sender_tx_diff_trees: list
    block_headers: list  # block hashes up to the previous block
    prev_block_header: BlockHeader
    prev_latest_account_digest: HashOut
    merge_proof: MergeProof  # sender 2's deposit-merge witness


def prove_user_txs_and_signatures(
    constants: RollupConstants | None = None,
    config: CircuitConfig | None = None,
    device=None,
    fused_sponge: bool = False,
    timings: dict | None = None,
) -> UserTxStages:
    """The flow's stages ``build_user_tx_circuit`` .. ``prove_signatures``
    (JAX ``models/rollup/block_flow.py::run_block_flow``), on ``device``
    (``None``: the CUDA device, raising without one).

    ``fused_sponge`` goes to the prover.  ``timings``, when given, receives
    seconds per stage (``build_user_tx_circuit``, ``state_setup``,
    ``prove_user_txs``, ``proposal_state``, ``build_zkdsa_circuit``,
    ``prove_signatures``) and, under ``prove_user_txs_phases`` and
    ``prove_signatures_phases``, the prover's seconds per phase."""
    constants = constants or RollupConstants.test_constants()
    config = config or CircuitConfig.standard_recursion_config()
    device = gl.resolve_device(device)
    stage = PhaseTimer(timings, device)
    phases = {}
    if timings is not None:
        phases = {"prove_user_txs": {}, "prove_signatures": {}}
        timings.update({f"{k}_phases": v for k, v in phases.items()})

    stage.phase("build_user_tx_circuit")
    aggregator_nodes = NodeDataMemory()
    world_state_tree = SparseMerkleTree(aggregator_nodes, RootDataTmp())
    merge_and_purge_circuit = make_user_proof_circuit(constants, config, device)
    stage.phase("state_setup")

    # --- sender 1: pure transfer (no merges) ---
    sender1_account = private_key_to_account(
        HashOut((17426287337377512978, 8703645504073070742, 11984317793392655464, 9979414176933652180))
    )
    s1_nodes = NodeDataMemory()
    sender1_user_asset_tree = UserAssetTree(s1_nodes, RootDataTmp())
    sender1_tx_diff_tree = LayeredLayeredSparseMerkleTree(s1_nodes, RootDataTmp())

    key1 = (HashOut.from_u128(12), HashOut.from_u128(305), HashOut.from_u128(8012))
    value1 = HashOut.from_u128(2053)
    key2 = (HashOut.from_u128(12), HashOut.from_u128(471), HashOut.from_u128(8012))
    value2 = HashOut.from_u128(1111)
    key3 = (HashOut.from_u128(407), HashOut.from_u128(305), HashOut.from_u128(8012))
    value3 = HashOut.from_u128(2053)
    key4 = (HashOut.from_u128(832), HashOut.from_u128(471), HashOut.from_u128(8012))
    value4 = HashOut.from_u128(1111)

    sender1_user_asset_tree.set(*key1, value1)
    sender1_user_asset_tree.set(*key2, value2)
    world_state_tree.set(
        sender1_account.address.to_hash_out(), sender1_user_asset_tree.get_root()
    )
    p1 = sender1_user_asset_tree.set(*key2, HashOut.ZERO)
    p2 = sender1_user_asset_tree.set(*key1, HashOut.ZERO)
    p3 = sender1_tx_diff_tree.set(*key3, value3)
    p4 = sender1_tx_diff_tree.set(*key4, value4)
    sender1_input_witness = [p1, p2]
    sender1_output_witness = [p3, p4]

    # --- sender 2: merges a deposit made in the previous block ---
    sender2_account = private_key_to_account(
        HashOut((15657143458229430356, 6012455030006979790, 4280058849535143691, 5153662694263190591))
    )
    s2_nodes = NodeDataMemory()
    sender2_user_asset_tree = UserAssetTree(s2_nodes, RootDataTmp())
    sender2_tx_diff_tree = LayeredLayeredSparseMerkleTree(s2_nodes, RootDataTmp())

    block1_deposit_tree = LayeredLayeredSparseMerkleTree(aggregator_nodes, RootDataTmp())
    s2_addr_h = sender2_account.address.to_hash_out()
    block1_deposit_tree.set(s2_addr_h, key1[1], key1[2], value1)
    block1_deposit_tree.set(s2_addr_h, key2[1], key2[2], value2)

    merge_inclusion_proof2 = calc_inclusion_proof(
        aggregator_nodes, block1_deposit_tree.get_root(), s2_addr_h
    )
    deposit_nonce = HashOut.ZERO
    deposit_diff_root = merge_inclusion_proof2.root
    deposit_tx_hash = two_to_one(deposit_diff_root, deposit_nonce)
    merge_inclusion_proof1 = get_merkle_proof([deposit_tx_hash], 0, constants.log_n_txs)

    default_inclusion_proof = SparseMerkleInclusionProof.with_root(HashOut.ZERO)
    default_merkle_root = get_merkle_proof([], 0, constants.log_n_txs).root
    prev_block_number = 1
    block_headers: list[HashOut] = [HashOut.ZERO] * prev_block_number
    prev_block_headers_digest = get_merkle_proof(
        block_headers, prev_block_number - 1, LOG_MAX_N_BLOCKS
    ).root

    prev_world_state_digest = world_state_tree.get_root()
    prev_latest_account_digest = HashOut.ZERO
    prev_block_header = BlockHeader(
        block_number=prev_block_number,
        prev_block_hash=HashOut.ZERO,
        block_headers_digest=prev_block_headers_digest,
        transactions_digest=default_merkle_root,
        deposit_digest=merge_inclusion_proof1.root,
        proposed_world_state_digest=prev_world_state_digest,
        approved_world_state_digest=prev_world_state_digest,
        latest_account_digest=prev_latest_account_digest,
    )
    prev_block_hash = get_block_hash(prev_block_header)
    block_headers.append(prev_block_hash)

    deposit_merge_key = two_to_one(deposit_tx_hash, prev_block_hash)

    sender2_user_asset_tree.set(deposit_merge_key, key1[1], key1[2], value1)
    sender2_user_asset_tree.set(deposit_merge_key, key2[1], key2[2], value2)

    # produce the merge-process insert proof via remove+reinsert on the
    # plain SMT view (bin/block_circuit.rs:243-253)
    s2_as_smt = SparseMerkleTree(s2_nodes, sender2_user_asset_tree.roots_db)
    asset_root = s2_as_smt.get(deposit_merge_key)
    s2_as_smt.set(deposit_merge_key, HashOut.ZERO)
    merge_process_proof = s2_as_smt.set(deposit_merge_key, asset_root)

    merge_proof = MergeProof(
        is_deposit=True,
        diff_tree_inclusion_proof=(
            prev_block_header, merge_inclusion_proof1, merge_inclusion_proof2
        ),
        merge_process_proof=merge_process_proof,
        latest_account_tree_inclusion_proof=default_inclusion_proof,
        nonce=deposit_nonce,
    )

    p1 = sender2_user_asset_tree.set(deposit_merge_key, key2[1], key2[2], HashOut.ZERO)
    p2 = sender2_user_asset_tree.set(deposit_merge_key, key1[1], key1[2], HashOut.ZERO)
    p3 = sender2_tx_diff_tree.set(*key3, value3)
    p4 = sender2_tx_diff_tree.set(*key4, value4)
    sender2_input_witness = [p1, p2]
    sender2_output_witness = [p3, p4]

    sender1_nonce = HashOut(
        (7823975322825286183, 9539665429968124165, 6825628074508059665, 17852854585777218254)
    )
    targets = merge_and_purge_circuit.targets
    pw1 = PartialWitness()
    expected1 = targets.set_witness(
        pw1, sender1_account.address, [],
        sender1_input_witness[: constants.n_diffs],
        sender1_output_witness[: constants.n_diffs],
        sender1_nonce, sender1_input_witness[0][0].old_root,
    )

    sender2_nonce = HashOut(
        (6657881311364026367, 11761473381903976612, 10768494808833234712, 3223267375194257474)
    )
    pw2 = PartialWitness()
    expected2 = targets.set_witness(
        pw2, sender2_account.address, [merge_proof],
        sender2_input_witness[: constants.n_diffs],
        sender2_output_witness[: constants.n_diffs],
        sender2_nonce, HashOut.ZERO,
    )

    pw3 = PartialWitness()
    expected3 = targets.set_witness(pw3, Address(0), [], [], [], HashOut.ZERO, HashOut.ZERO)
    stage.phase("prove_user_txs")
    user_tx_witnesses = [pw1, pw2, pw3]
    user_tx_proofs = prove_batch(
        merge_and_purge_circuit.data, user_tx_witnesses, fused_sponge=fused_sponge,
        timings=phases.get("prove_user_txs"),
    )
    stage.phase("proposal_state")

    # --- proposal ---
    ws1 = world_state_tree.set(
        sender1_account.address.to_hash_out(), sender1_user_asset_tree.get_root()
    )
    ws2 = world_state_tree.set(
        sender2_account.address.to_hash_out(), sender2_user_asset_tree.get_root()
    )
    proposal_world_state_root = world_state_tree.get_root()

    stage.phase("build_zkdsa_circuit")
    zkdsa_circuit = make_simple_signature_circuit(config, device)
    stage.phase("prove_signatures")
    pw1 = PartialWitness()
    zkdsa_circuit.targets.set_witness(
        pw1, sender2_account.private_key, proposal_world_state_root
    )
    pw2 = PartialWitness()
    zkdsa_circuit.targets.set_witness(pw2, HashOut.ZERO, HashOut.ZERO)
    signature_witnesses = [pw1, pw2]
    signature_proofs = prove_batch(
        zkdsa_circuit.data, signature_witnesses, fused_sponge=fused_sponge,
        timings=phases.get("prove_signatures"),
    )
    stage.phase("_end")  # closes the last stage

    return UserTxStages(
        user_tx_circuit=merge_and_purge_circuit,
        zkdsa_circuit=zkdsa_circuit,
        user_tx_witnesses=user_tx_witnesses,
        user_tx_public_inputs=[expected1, expected2, expected3],
        user_tx_nonces=[sender1_nonce, sender2_nonce, HashOut.ZERO],
        user_tx_proofs=user_tx_proofs,
        signature_witnesses=signature_witnesses,
        signature_proofs=signature_proofs,
        aggregator_nodes=aggregator_nodes,
        world_state_tree=world_state_tree,
        world_state_process_proofs=[ws1, ws2],
        proposal_world_state_root=proposal_world_state_root,
        sender_accounts=[sender1_account, sender2_account],
        sender_user_asset_trees=[sender1_user_asset_tree, sender2_user_asset_tree],
        sender_tx_diff_trees=[sender1_tx_diff_tree, sender2_tx_diff_tree],
        block_headers=block_headers,
        prev_block_header=prev_block_header,
        prev_latest_account_digest=prev_latest_account_digest,
        merge_proof=merge_proof,
    )
