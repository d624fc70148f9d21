"""End-to-end block production flow -- the counterpart of the reference's
flagship binary (``src/bin/block_circuit.rs:48-663``): two senders (one
transfer-only, one merging a deposit from the previous block), proposal +
approval, block assembly, and ``BlockInfo`` (the ``block1_info.json``
format).

``prove_user_txs_and_signatures`` runs the flow from building the
user-transaction circuit through proving the signatures: the two senders'
transactions and a default one, proved as one batch; the proposal's world
state; the second sender's signature of it and a default signature, proved
as a second batch (``prove_batch``; the JAX flow's device rule, a batch on
an accelerator and a loop of single proofs on the CPU, has nothing to
choose here: ``prove`` is ``prove_batch`` at K = 1).  ``run_block_flow``
runs those stages (or takes them from the caller), then builds the block
circuit, sets its witness, proves and verifies it.

``prove=False`` runs every circuit's witness through
``CircuitData.check_witness`` (all gate constraints evaluated on the
subgroup) instead of producing proofs -- the fast integration-test mode; its
block circuit takes the inner public inputs as checked (trusted
aggregation), since there is no inner proof to verify in the circuit.
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
from ..recursion.gadgets import CheckedPublicInputs
from ..sparse_merkle_tree import (
    LayeredLayeredSparseMerkleTree,
    SparseMerkleInclusionProof,
    SparseMerkleTree,
)
from ..sparse_merkle_tree.node_data import NodeDataMemory, RootDataTmp
from ..sparse_merkle_tree.tree import calc_inclusion_proof
from ..transaction.block_header import BlockHeader, get_block_hash
from ..transaction.circuits import (
    MergeAndPurgeTransitionPublicInputs,
    make_user_proof_circuit,
)
from ..transaction.gadgets.merge import MergeProof
from ..transaction.user_asset_tree import UserAssetTree
from ..zkdsa.account import Address, private_key_to_account
from ..zkdsa.circuits import SimpleSignaturePublicInputs, make_simple_signature_circuit
from .address_list import TransactionSenderWithValidity
from .block import BlockInfo
from .circuits import BlockDetail, BlockProductionProofWithPublicInputs, make_block_proof_circuit
from .gadgets.deposit_block import DepositInfo, VariableIndex


def _prove_group(circuit, pws: list, prove: bool, fused_sponge: bool, timings) -> list:
    """One ``prove_batch`` call for the witnesses of one circuit, or, with
    ``prove=False``, each witness checked."""
    if not prove:
        return [CheckedPublicInputs(public_inputs=circuit.data.check_witness(pw)) for pw in pws]
    return prove_batch(circuit.data, pws, fused_sponge=fused_sponge, timings=timings)


@dataclass
class UserTxStages:
    """What the flow's stages up to ``prove_signatures`` give the later ones."""

    user_tx_circuit: object
    zkdsa_circuit: object
    user_tx_witnesses: list  # PartialWitness: sender 1, sender 2, the default transaction
    user_tx_public_inputs: list  # the MergeAndPurgeTransitionPublicInputs each must give
    user_tx_nonces: list  # HashOut per transaction
    user_tx_proofs: list  # proofs, or CheckedPublicInputs when not proving
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
    prove: bool = True,
) -> UserTxStages:
    """The flow's stages ``build_user_tx_circuit`` .. ``prove_signatures``
    (JAX ``models/rollup/block_flow.py::run_block_flow``), on ``device``
    (``None``: the CUDA device, raising without one).  ``prove=False``
    checks each witness (``check_witness``) instead of proving it.

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
    user_tx_proofs = _prove_group(
        merge_and_purge_circuit, user_tx_witnesses, prove, fused_sponge,
        phases.get("prove_user_txs"),
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
    signature_proofs = _prove_group(
        zkdsa_circuit, signature_witnesses, prove, fused_sponge,
        phases.get("prove_signatures"),
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


@dataclass
class BlockFlowResult:
    block_info: BlockInfo
    block_detail: BlockDetail
    block_proof: object  # BlockProductionProofWithPublicInputs | public inputs
    user_tx_proofs: list
    block_circuit: object
    merge_proofs: list = None  # sender 2's deposit-merge witness bundle
    stages: UserTxStages = None


def run_block_flow(
    constants: RollupConstants | None = None,
    config: CircuitConfig | None = None,
    prove: bool = True,
    recursive: bool = True,
    device=None,
    timings: dict | None = None,
    stages: UserTxStages | None = None,
) -> BlockFlowResult:
    """The whole flow on ``device`` (``None``: the CUDA device, raising
    without one).  ``recursive=True`` (reference parity --
    ``rollup/circuits/mod.rs:450-489``) verifies the user-tx and signature
    proofs in the block circuit; ``False`` (and every ``prove=False`` run)
    uses the trusted-aggregation mode (inner proofs verified on the host at
    witness time -- a weaker object, a much smaller circuit).

    ``stages``: the result of ``prove_user_txs_and_signatures`` at the same
    constants, config and ``prove``, whose stages are then not run again; the
    flow goes on changing its world-state tree, so one result serves one
    flow.  ``timings``, when given, receives seconds per stage (those of
    ``prove_user_txs_and_signatures`` when it runs, then
    ``build_block_circuit``, ``block_state``, and ``block_witness``,
    ``prove_block``, ``verify_block``, or ``check_block``) and, under
    ``prove_block_phases``, the block prove's seconds per phase."""
    constants = constants or RollupConstants.test_constants()
    config = config or CircuitConfig.standard_recursion_config()
    device = gl.resolve_device(device)
    if stages is None:
        stages = prove_user_txs_and_signatures(constants, config, device, timings=timings,
                                               prove=prove)
    stage = PhaseTimer(timings, device)
    block_phases = None
    if timings is not None and prove:
        block_phases = timings.setdefault("prove_block_phases", {})

    merge_and_purge_circuit = stages.user_tx_circuit
    zkdsa_circuit = stages.zkdsa_circuit
    world_state_tree = stages.world_state_tree
    sender2_received_signature, default_signature_proof = stages.signature_proofs
    default_user_tx_proof = stages.user_tx_proofs[2]
    user_tx_proofs = list(stages.user_tx_proofs[:2])
    prev_block_header = stages.prev_block_header

    stage.phase("build_block_circuit")
    block_circuit = make_block_proof_circuit(
        constants, merge_and_purge_circuit, zkdsa_circuit, config,
        recursive=recursive and prove, device=device,
    )
    stage.phase("block_state")

    block_number = prev_block_header.block_number + 1
    received_signature_proofs = [None, sender2_received_signature]
    received_signatures = [
        None if p is None else SimpleSignaturePublicInputsFromProof(p)
        for p in received_signature_proofs
    ]

    latest_account_tree = SparseMerkleTree(
        NodeDataMemory(), RootDataTmp(stages.prev_latest_account_digest))

    world_state_revert_proofs = []
    latest_account_process_proofs = []
    user_transactions = [
        MergeAndPurgeTransitionPublicInputs.decode(p.public_inputs) for p in user_tx_proofs
    ]
    for sig, user_tx in zip(received_signatures, user_transactions):
        user_address = user_tx.sender_address
        if sig is None:
            old_block_number = latest_account_tree.get(user_address.to_hash_out())
            last_block_number = old_block_number.to_u32()
            confirmed_user_asset_root = user_tx.middle_user_asset_root
        else:
            last_block_number = block_number
            confirmed_user_asset_root = user_tx.new_user_asset_root
        latest_account_process_proofs.append(
            latest_account_tree.set(
                user_address.to_hash_out(), HashOut.from_u32(last_block_number)
            )
        )
        world_state_revert_proofs.append(
            world_state_tree.set(user_address.to_hash_out(), confirmed_user_asset_root)
        )

    prev_block_number = prev_block_header.block_number
    bh_proof = get_merkle_proof(stages.block_headers, prev_block_number, LOG_MAX_N_BLOCKS)

    sender2_account = stages.sender_accounts[1]
    block2_deposit_list = [
        DepositInfo(
            receiver_address=sender2_account.address,
            contract_address=Address(1),
            variable_index=VariableIndex(0),
            amount=1,
        )
    ]
    block2_deposit_tree = LayeredLayeredSparseMerkleTree(stages.aggregator_nodes, RootDataTmp())
    deposit_process_proofs = [
        block2_deposit_tree.set(
            leaf.receiver_address.to_hash_out(),
            leaf.contract_address.to_hash_out(),
            leaf.variable_index.to_hash_out(),
            HashOut((leaf.amount, 0, 0, 0)),
        )
        for leaf in block2_deposit_list
    ][: constants.n_deposits]

    detail = BlockDetail(
        block_number=block_number,
        user_tx_proofs=user_tx_proofs,
        deposit_process_proofs=deposit_process_proofs,
        scroll_process_proofs=[],
        polygon_process_proofs=[],
        world_state_process_proofs=stages.world_state_process_proofs,
        world_state_revert_proofs=world_state_revert_proofs,
        received_signature_proofs=received_signature_proofs,
        latest_account_process_proofs=latest_account_process_proofs,
        block_headers_proof_siblings=bh_proof.siblings,
        prev_block_header=prev_block_header,
    )

    if prove:
        stage.phase("block_witness")
        pw, block_pis = block_circuit.witness(
            detail, default_user_tx_proof, default_signature_proof)
        stage.phase("prove_block")
        proof = block_circuit.data.prove(pw, timings=block_phases)
        assert proof.public_inputs == list(block_pis.get_entry_hash().elements), (
            "entry hash mismatch"
        )
        block_proof = BlockProductionProofWithPublicInputs(proof=proof, public_inputs=block_pis)
        stage.phase("verify_block")
        block_circuit.verify(block_proof)
    else:
        stage.phase("check_block")
        pw, block_pis = block_circuit.witness(
            detail, default_user_tx_proof, default_signature_proof)
        got_pis = block_circuit.data.check_witness(pw)
        assert got_pis == list(block_pis.get_entry_hash().elements), "entry hash mismatch"
        block_proof = block_pis
    stage.phase("_end")  # closes the last stage

    # --- BlockInfo (the block1_info.json format) ---
    address_list = [
        TransactionSenderWithValidity(
            sender_address=u.sender_address, is_valid=s is not None
        )
        for u, s in zip(user_transactions, received_signatures)
    ]
    block_info = BlockInfo(
        header=block_circuit.targets.computed_block_header,
        transactions=[u.tx_hash for u in user_transactions],
        deposit_list=block2_deposit_list,
        scroll_flag_list=[],
        polygon_flag_list=[],
        address_list=address_list,
    )

    return BlockFlowResult(
        block_info=block_info,
        block_detail=detail,
        block_proof=block_proof,
        user_tx_proofs=user_tx_proofs,
        block_circuit=block_circuit,
        merge_proofs=[stages.merge_proof],
        stages=stages,
    )


def SimpleSignaturePublicInputsFromProof(proof):
    return SimpleSignaturePublicInputs.decode(proof.public_inputs)
