"""Block production circuit (reference ``src/rollup/circuits/mod.rs``):
3 deposit-block instances (deposit/scroll/polygon), proposal + approval
transitions, n_txs recursively-wrapped user-tx proofs + n_txs signature
proofs cross-wired by public inputs, block-header assembly, and a single
public input: the Poseidon entry hash of the full PI struct."""

from __future__ import annotations

from dataclasses import dataclass, field

from ...config import LOG_MAX_N_BLOCKS, RollupConstants
from ...engine.circuit import CircuitBuilder, CircuitData, HashOutTarget
from ...engine.config import CircuitConfig
from ...engine.witness import PartialWitness
from ...utils.hash_out import HashOut
from ...utils.poseidon_host import hash_no_pad
from ..merkle_tree.gadgets import MerkleProofTarget, get_merkle_root_target_from_leaves
from ..merkle_tree.tree import get_merkle_proof, get_merkle_root, log2_ceil
from ..recursion.gadgets import RecursiveProofTarget
from ..transaction.block_header import BlockHeader, get_block_hash
from ..transaction.circuits import (
    MergeAndPurgeTransitionCircuit,
    MergeAndPurgeTransitionPublicInputs,
    MergeAndPurgeTransitionPublicInputsTarget,
)
from ..transaction.gadgets.block_header import BlockHeaderTarget, get_block_hash_target
from ..zkdsa.account import Address
from ..zkdsa.circuits import (
    SimpleSignatureCircuit,
    SimpleSignaturePublicInputs,
    SimpleSignaturePublicInputsTarget,
)
from .address_list import TransactionSenderWithValidity
from .gadgets.approval_block import ApprovalBlockProductionTarget
from .gadgets.block_headers_tree import calc_block_headers_proof
from .gadgets.deposit_block import (
    DepositBlockProductionTarget,
    DepositInfo,
    DepositInfoTarget,
    VariableIndex,
)
from .gadgets.proposal_block import ProposalBlockProductionTarget


@dataclass
class TransactionSenderWithValidityTarget:
    sender_address: HashOutTarget
    is_valid: object  # BoolTarget


@dataclass
class BlockProductionPublicInputs:
    """``rollup/circuits/mod.rs:635-861``; fixed encoded length
    5*n_txs + 13*(n_deposits+n_scroll+n_polygon) + 28."""

    address_list: list[TransactionSenderWithValidity]
    deposit_list: list[DepositInfo]
    scroll_flag_list: list[DepositInfo]
    polygon_flag_list: list[DepositInfo]
    old_account_tree_root: HashOut
    new_account_tree_root: HashOut
    old_world_state_root: HashOut
    new_world_state_root: HashOut
    old_prev_block_header_digest: HashOut
    new_prev_block_header_digest: HashOut
    block_hash: HashOut

    def encode(self) -> list[int]:
        out: list[int] = []
        for entry in self.address_list:
            entry.sender_address.write(out)
            out.append(1 if entry.is_valid else 0)
        for lst in (self.deposit_list, self.scroll_flag_list, self.polygon_flag_list):
            for d in lst:
                d.receiver_address.write(out)
                d.contract_address.write(out)
                d.variable_index.write(out)
                out.append(d.amount % 0xFFFFFFFF00000001)
        for h in (
            self.old_account_tree_root,
            self.new_account_tree_root,
            self.old_world_state_root,
            self.new_world_state_root,
            self.old_prev_block_header_digest,
            self.new_prev_block_header_digest,
            self.block_hash,
        ):
            h.write(out)
        return out

    @classmethod
    def decode(
        cls, public_inputs: list[int], n_txs: int, n_deposits: int,
        n_scroll_flags: int, n_polygon_flags: int,
    ) -> "BlockProductionPublicInputs":
        expected = 5 * n_txs + 13 * (n_deposits + n_scroll_flags + n_polygon_flags) + 28
        assert len(public_inputs) == expected
        it = iter(public_inputs)
        address_list = [
            TransactionSenderWithValidity(
                sender_address=Address.read(it), is_valid=next(it) != 0
            )
            for _ in range(n_txs)
        ]

        def read_deposits(n):
            return [
                DepositInfo(
                    receiver_address=Address.read(it),
                    contract_address=Address.read(it),
                    variable_index=VariableIndex.read(it),
                    amount=next(it),
                )
                for _ in range(n)
            ]

        deposit_list = read_deposits(n_deposits)
        scroll_flag_list = read_deposits(n_scroll_flags)
        polygon_flag_list = read_deposits(n_polygon_flags)
        digests = [HashOut.read(it) for _ in range(7)]
        assert next(it, None) is None
        return cls(
            address_list=address_list,
            deposit_list=deposit_list,
            scroll_flag_list=scroll_flag_list,
            polygon_flag_list=polygon_flag_list,
            old_account_tree_root=digests[0],
            new_account_tree_root=digests[1],
            old_world_state_root=digests[2],
            new_world_state_root=digests[3],
            old_prev_block_header_digest=digests[4],
            new_prev_block_header_digest=digests[5],
            block_hash=digests[6],
        )

    def get_entry_hash(self) -> HashOut:
        return hash_no_pad(self.encode())

    def to_json(self) -> dict:
        """Reference serde layout (``rollup/circuits/mod.rs:655-669``,
        ``SerializableBlockProductionPublicInputs``): snake_case fields,
        hex digests."""
        return {
            "address_list": [e.to_json() for e in self.address_list],
            "deposit_list": [d.to_json() for d in self.deposit_list],
            "scroll_flag_list": [d.to_json() for d in self.scroll_flag_list],
            "polygon_flag_list": [d.to_json() for d in self.polygon_flag_list],
            "old_account_tree_root": self.old_account_tree_root.to_hex(),
            "new_account_tree_root": self.new_account_tree_root.to_hex(),
            "old_world_state_root": self.old_world_state_root.to_hex(),
            "new_world_state_root": self.new_world_state_root.to_hex(),
            "old_prev_block_header_digest": self.old_prev_block_header_digest.to_hex(),
            "new_prev_block_header_digest": self.new_prev_block_header_digest.to_hex(),
            "block_hash": self.block_hash.to_hex(),
        }

    @classmethod
    def from_json(cls, o: dict) -> "BlockProductionPublicInputs":
        return cls(
            address_list=[
                TransactionSenderWithValidity.from_json(e) for e in o["address_list"]
            ],
            deposit_list=[DepositInfo.from_json(d) for d in o["deposit_list"]],
            scroll_flag_list=[DepositInfo.from_json(d) for d in o["scroll_flag_list"]],
            polygon_flag_list=[DepositInfo.from_json(d) for d in o["polygon_flag_list"]],
            old_account_tree_root=HashOut.from_hex(o["old_account_tree_root"]),
            new_account_tree_root=HashOut.from_hex(o["new_account_tree_root"]),
            old_world_state_root=HashOut.from_hex(o["old_world_state_root"]),
            new_world_state_root=HashOut.from_hex(o["new_world_state_root"]),
            old_prev_block_header_digest=HashOut.from_hex(
                o["old_prev_block_header_digest"]
            ),
            new_prev_block_header_digest=HashOut.from_hex(
                o["new_prev_block_header_digest"]
            ),
            block_hash=HashOut.from_hex(o["block_hash"]),
        )


@dataclass
class BlockProductionPublicInputsTarget:
    address_list: list[TransactionSenderWithValidityTarget]
    deposit_list: list[DepositInfoTarget]
    scroll_flag_list: list[DepositInfoTarget]
    polygon_flag_list: list[DepositInfoTarget]
    old_account_tree_root: HashOutTarget
    new_account_tree_root: HashOutTarget
    old_world_state_root: HashOutTarget
    new_world_state_root: HashOutTarget
    old_block_headers_root: HashOutTarget
    new_block_headers_root: HashOutTarget
    block_hash: HashOutTarget

    def encode(self, builder: CircuitBuilder) -> list[int]:
        zero = builder.zero()
        out: list[int] = []
        for entry in self.address_list:
            out.extend(list(entry.sender_address))
            out.append(entry.is_valid.target)
        for lst in (self.deposit_list, self.scroll_flag_list, self.polygon_flag_list):
            for d in lst:
                out.extend(list(d.receiver_address))
                out.extend(list(d.contract_address))
                out.extend(list(d.variable_index))
                out.append(d.amount)
        for h in (
            self.old_account_tree_root,
            self.new_account_tree_root,
            self.old_world_state_root,
            self.new_world_state_root,
            self.old_block_headers_root,
            self.new_block_headers_root,
            self.block_hash,
        ):
            out.extend(list(h))
        return out

    def get_entry_hash(self, builder: CircuitBuilder) -> HashOutTarget:
        return builder.hash_n_to_hash_no_pad(self.encode(builder))


@dataclass
class BlockDetail:
    """``rollup/circuits/mod.rs:69-84``: everything needed to produce one
    block."""

    block_number: int
    user_tx_proofs: list
    deposit_process_proofs: list
    scroll_process_proofs: list
    polygon_process_proofs: list
    world_state_process_proofs: list
    world_state_revert_proofs: list
    received_signature_proofs: list
    latest_account_process_proofs: list
    block_headers_proof_siblings: list[HashOut]
    prev_block_header: BlockHeader

    @classmethod
    def new(cls, log_num_txs_in_block: int) -> "BlockDetail":
        prev_block_header = BlockHeader.new(log_num_txs_in_block)
        prev_block_hash = get_block_hash(prev_block_header)
        prev_block_number = prev_block_header.block_number
        block_headers = [HashOut.ZERO] * prev_block_number + [prev_block_hash]
        siblings = get_merkle_proof(
            block_headers, prev_block_number, LOG_MAX_N_BLOCKS
        ).siblings
        return cls(
            block_number=prev_block_number + 1,
            user_tx_proofs=[],
            deposit_process_proofs=[],
            scroll_process_proofs=[],
            polygon_process_proofs=[],
            world_state_process_proofs=[],
            world_state_revert_proofs=[],
            received_signature_proofs=[],
            latest_account_process_proofs=[],
            block_headers_proof_siblings=siblings,
            prev_block_header=prev_block_header,
        )

    def to_json(self) -> dict:
        """Reference serde layout (``rollup/circuits/mod.rs:69-84``): the
        full block-production witness as one JSON checkpoint.  Inner
        user-tx/signature proofs serialize in THIS engine's proof format
        (``engine/serde.py``) — the schema (field names, tuple-as-array
        process-proof triples, null for absent signatures) matches the
        reference; proof bytes are engine-specific by construction."""
        from ...engine.serde import proof_to_json

        def triples(lst):
            return [[p.to_json() for p in t] for t in lst]

        return {
            "block_number": self.block_number,
            "user_tx_proofs": [proof_to_json(p) for p in self.user_tx_proofs],
            "deposit_process_proofs": triples(self.deposit_process_proofs),
            "scroll_process_proofs": triples(self.scroll_process_proofs),
            "polygon_process_proofs": triples(self.polygon_process_proofs),
            "world_state_process_proofs": [
                p.to_json() for p in self.world_state_process_proofs
            ],
            "world_state_revert_proofs": [
                p.to_json() for p in self.world_state_revert_proofs
            ],
            "received_signature_proofs": [
                None if p is None else proof_to_json(p)
                for p in self.received_signature_proofs
            ],
            "latest_account_process_proofs": [
                p.to_json() for p in self.latest_account_process_proofs
            ],
            "block_headers_proof_siblings": [
                s.to_hex() for s in self.block_headers_proof_siblings
            ],
            "prev_block_header": self.prev_block_header.to_json(),
        }

    @classmethod
    def from_json(cls, o: dict) -> "BlockDetail":
        from ...engine.serde import proof_from_json
        from ..sparse_merkle_tree.proofs import SparseMerkleProcessProof

        def triples(lst):
            return [
                tuple(SparseMerkleProcessProof.from_json(p) for p in t) for t in lst
            ]

        return cls(
            block_number=o["block_number"],
            user_tx_proofs=[proof_from_json(p) for p in o["user_tx_proofs"]],
            deposit_process_proofs=triples(o["deposit_process_proofs"]),
            scroll_process_proofs=triples(o["scroll_process_proofs"]),
            polygon_process_proofs=triples(o["polygon_process_proofs"]),
            world_state_process_proofs=[
                SparseMerkleProcessProof.from_json(p)
                for p in o["world_state_process_proofs"]
            ],
            world_state_revert_proofs=[
                SparseMerkleProcessProof.from_json(p)
                for p in o["world_state_revert_proofs"]
            ],
            received_signature_proofs=[
                None if p is None else proof_from_json(p)
                for p in o["received_signature_proofs"]
            ],
            latest_account_process_proofs=[
                SparseMerkleProcessProof.from_json(p)
                for p in o["latest_account_process_proofs"]
            ],
            block_headers_proof_siblings=[
                HashOut.from_hex(s) for s in o["block_headers_proof_siblings"]
            ],
            prev_block_header=BlockHeader.from_json(o["prev_block_header"]),
        )


@dataclass
class BlockProductionTarget:
    deposit_block_target: DepositBlockProductionTarget
    scroll_block_target: DepositBlockProductionTarget
    polygon_block_target: DepositBlockProductionTarget
    proposal_block_target: ProposalBlockProductionTarget
    approval_block_target: ApprovalBlockProductionTarget
    user_tx_proofs: list[RecursiveProofTarget]
    received_signature_proofs: list[RecursiveProofTarget]
    block_headers_proof: MerkleProofTarget
    prev_block_header: BlockHeaderTarget
    block_header: BlockHeaderTarget

    def set_witness(
        self,
        pw: PartialWitness,
        block_number: int,
        user_tx_proofs: list,
        default_user_tx_proof,
        deposit_process_proofs: list,
        scroll_process_proofs: list,
        polygon_process_proofs: list,
        world_state_process_proofs: list,
        world_state_revert_proofs: list,
        received_signature_proofs: list,
        default_simple_signature_proof,
        latest_account_process_proofs: list,
        block_headers_proof_siblings: list[HashOut],
        prev_block_header: BlockHeader,
    ) -> BlockProductionPublicInputs:
        """``rollup/circuits/mod.rs:164-386``."""
        n_txs = len(self.user_tx_proofs)
        n_deposits = len(self.deposit_block_target.deposit_process_proofs)
        n_scroll = len(self.scroll_block_target.deposit_process_proofs)
        n_polygon = len(self.polygon_block_target.deposit_process_proofs)

        interior_deposit_digest = self.deposit_block_target.set_witness(
            pw, deposit_process_proofs
        )
        interior_scroll_digest = self.scroll_block_target.set_witness(
            pw, scroll_process_proofs
        )
        interior_polygon_digest = self.polygon_block_target.set_witness(
            pw, polygon_process_proofs
        )
        old_world_state_root = prev_block_header.approved_world_state_digest
        user_transactions = [
            MergeAndPurgeTransitionPublicInputs.decode(p.public_inputs)
            for p in user_tx_proofs
        ]
        transactions_digest, proposed_world_state_digest = (
            self.proposal_block_target.set_witness(
                pw, world_state_process_proofs, user_transactions, old_world_state_root
            )
        )
        old_latest_account_root = prev_block_header.latest_account_digest
        received_signatures = [
            SimpleSignaturePublicInputs.decode(p.public_inputs) if p is not None else None
            for p in received_signature_proofs
        ]
        approved_world_state_digest, latest_account_digest = (
            self.approval_block_target.set_witness(
                pw,
                block_number,
                world_state_revert_proofs,
                user_transactions,
                received_signatures,
                latest_account_process_proofs,
                proposed_world_state_digest,
                old_latest_account_root,
            )
        )

        assert len(user_tx_proofs) <= n_txs
        for t, p in zip(self.user_tx_proofs, user_tx_proofs):
            t.set_witness(pw, p, True)
        for t in self.user_tx_proofs[len(user_tx_proofs):]:
            t.set_witness(pw, default_user_tx_proof, False)

        assert len(received_signature_proofs) <= n_txs
        for t, p in zip(self.received_signature_proofs, received_signature_proofs):
            t.set_witness(
                pw, p if p is not None else default_simple_signature_proof, p is not None
            )
        for t in self.received_signature_proofs[len(received_signature_proofs):]:
            t.set_witness(pw, default_simple_signature_proof, False)

        self.prev_block_header.set_witness(pw, prev_block_header)
        for t, s in zip(self.block_headers_proof.siblings, block_headers_proof_siblings):
            pw.set_hash_target(t, s)

        prev_block_number = prev_block_header.block_number
        prev_block_headers_digest = get_merkle_root(
            prev_block_number, HashOut.ZERO, block_headers_proof_siblings
        )
        assert prev_block_headers_digest == prev_block_header.block_headers_digest
        prev_block_hash = get_block_hash(prev_block_header)
        block_headers_digest = get_merkle_root(
            prev_block_number, prev_block_hash, block_headers_proof_siblings
        )

        log_n_txs = log2_ceil(n_txs)
        assert 1 << log_n_txs == n_txs
        deposit_digest = get_merkle_proof(
            [interior_deposit_digest, interior_scroll_digest, interior_polygon_digest],
            0,
            log_n_txs,
        ).root

        block_header = BlockHeader(
            block_number=block_number,
            prev_block_hash=prev_block_hash,
            transactions_digest=transactions_digest,
            deposit_digest=deposit_digest,
            proposed_world_state_digest=proposed_world_state_digest,
            approved_world_state_digest=approved_world_state_digest,
            latest_account_digest=latest_account_digest,
            block_headers_digest=block_headers_digest,
        )
        block_hash = get_block_hash(block_header)
        # expose the assembled header for callers building BlockInfo
        self.computed_block_header = block_header

        address_list = [
            TransactionSenderWithValidity(
                sender_address=u.sender_address, is_valid=s is not None
            )
            for u, s in zip(user_transactions, received_signatures)
        ]
        address_list += [
            TransactionSenderWithValidity(sender_address=Address(0), is_valid=False)
        ] * (n_txs - len(address_list))

        def to_deposit_list(proofs, n):
            lst = [
                DepositInfo(
                    receiver_address=Address.from_hash_out(p0.new_key),
                    contract_address=Address.from_hash_out(p1.new_key),
                    variable_index=VariableIndex.from_hash_out(p2.new_key),
                    amount=p2.new_value.elements[0],
                )
                for (p0, p1, p2) in proofs
            ]
            default = DepositInfo(
                receiver_address=Address(0), contract_address=Address(0),
                variable_index=VariableIndex(0), amount=0,
            )
            return lst + [default] * (n - len(lst))

        return BlockProductionPublicInputs(
            address_list=address_list,
            deposit_list=to_deposit_list(deposit_process_proofs, n_deposits),
            scroll_flag_list=to_deposit_list(scroll_process_proofs, n_scroll),
            polygon_flag_list=to_deposit_list(polygon_process_proofs, n_polygon),
            old_account_tree_root=prev_block_header.latest_account_digest,
            new_account_tree_root=block_header.latest_account_digest,
            old_world_state_root=prev_block_header.approved_world_state_digest,
            new_world_state_root=block_header.approved_world_state_digest,
            old_prev_block_header_digest=prev_block_header.block_headers_digest,
            new_prev_block_header_digest=block_header.block_headers_digest,
            block_hash=block_hash,
        )


@dataclass
class BlockProductionProofWithPublicInputs:
    proof: object
    public_inputs: BlockProductionPublicInputs


@dataclass
class BlockProductionCircuit:
    data: CircuitData
    targets: BlockProductionTarget
    constants: RollupConstants

    def witness(self, detail: BlockDetail, default_user_tx_proof,
                default_simple_signature_proof):
        """The partial witness of ``detail`` and the public inputs it must
        give."""
        pw = PartialWitness()
        pis = self.targets.set_witness(
            pw,
            detail.block_number,
            detail.user_tx_proofs,
            default_user_tx_proof,
            detail.deposit_process_proofs,
            detail.scroll_process_proofs,
            detail.polygon_process_proofs,
            detail.world_state_process_proofs,
            detail.world_state_revert_proofs,
            detail.received_signature_proofs,
            default_simple_signature_proof,
            detail.latest_account_process_proofs,
            detail.block_headers_proof_siblings,
            detail.prev_block_header,
        )
        return pw, pis

    def set_witness_and_prove(self, detail: BlockDetail, default_user_tx_proof,
                              default_simple_signature_proof) -> BlockProductionProofWithPublicInputs:
        """``rollup/circuits/mod.rs:1223-1260``."""
        pw, pis = self.witness(detail, default_user_tx_proof, default_simple_signature_proof)
        proof = self.data.prove(pw)
        entry_hash = pis.get_entry_hash()
        assert proof.public_inputs == list(entry_hash.elements), "entry hash mismatch"
        return BlockProductionProofWithPublicInputs(proof=proof, public_inputs=pis)

    def verify(self, proof_with_pis: BlockProductionProofWithPublicInputs) -> None:
        entry_hash = proof_with_pis.public_inputs.get_entry_hash()
        assert proof_with_pis.proof.public_inputs == list(entry_hash.elements), (
            "entry hash mismatch"
        )
        self.data.verify(proof_with_pis.proof)


def prove_block_production(
    rollup_constants: RollupConstants,
    detail: BlockDetail,
    config: CircuitConfig | None = None,
    recursive: bool = True,
    device=None,
):
    """One-shot flow (``rollup/circuits/mod.rs:1272-1326``): build the user
    and signature circuits, prove their defaults for disabled slots, build
    the block circuit, prove and verify.  ``device=None`` builds and proves
    on the CUDA device and raises when there is none."""
    from ..transaction.circuits import make_user_proof_circuit
    from ..zkdsa.circuits import make_simple_signature_circuit

    user_circuit = make_user_proof_circuit(rollup_constants, config, device)
    pw = PartialWitness()
    user_circuit.targets.set_witness(pw, Address(0), [], [], [], HashOut.ZERO, HashOut.ZERO)
    default_user_tx_proof = user_circuit.data.prove(pw)

    sig_circuit = make_simple_signature_circuit(config, device)
    pw = PartialWitness()
    sig_circuit.targets.set_witness(pw, HashOut.ZERO, HashOut.ZERO)
    default_signature_proof = sig_circuit.data.prove(pw)

    block_circuit = make_block_proof_circuit(
        rollup_constants, user_circuit, sig_circuit, config, recursive=recursive,
        device=device,
    )
    proof = block_circuit.set_witness_and_prove(
        detail, default_user_tx_proof, default_signature_proof
    )
    block_circuit.verify(proof)
    return block_circuit, proof


def make_block_proof_circuit(
    rollup_constants: RollupConstants,
    merge_and_purge_circuit: MergeAndPurgeTransitionCircuit,
    simple_signature_circuit: SimpleSignatureCircuit,
    config: CircuitConfig | None = None,
    recursive: bool = True,
    device=None,
) -> BlockProductionCircuit:
    """``rollup/circuits/mod.rs:389-624``.  ``device=None`` builds (and
    later proves) on the CUDA device and raises when there is none.

    Conscious fix vs the reference (documented in SURVEY §7 quirks): the
    in-circuit deposit_digest includes the polygon interior digest like the
    witness side does (the reference omits it in-circuit, which only agrees
    while the polygon digest is zero)."""
    builder = CircuitBuilder(config or CircuitConfig.standard_recursion_config(), device)
    n_txs = 1 << rollup_constants.log_n_txs

    deposit_block_target = DepositBlockProductionTarget.add_virtual_to(
        builder,
        rollup_constants.log_n_recipients,
        rollup_constants.log_n_contracts,
        rollup_constants.log_n_variables,
        rollup_constants.n_deposits,
    )
    scroll_block_target = DepositBlockProductionTarget.add_virtual_to(
        builder,
        rollup_constants.log_n_recipients,
        rollup_constants.log_n_contracts,
        rollup_constants.log_n_variables,
        rollup_constants.n_deposits,
    )
    polygon_block_target = DepositBlockProductionTarget.add_virtual_to(
        builder,
        rollup_constants.log_n_recipients,
        rollup_constants.log_n_contracts,
        rollup_constants.log_n_variables,
        rollup_constants.n_deposits,
    )
    proposal_block_target = ProposalBlockProductionTarget.add_virtual_to(
        builder, rollup_constants.log_max_n_users, n_txs
    )
    approval_block_target = ApprovalBlockProductionTarget.add_virtual_to(
        builder, rollup_constants.log_max_n_users, n_txs
    )

    user_tx_proofs = [
        RecursiveProofTarget.add_virtual_to(
            builder, merge_and_purge_circuit.data, in_circuit=recursive
        )
        for _ in range(n_txs)
    ]
    for u, p, a in zip(
        user_tx_proofs,
        proposal_block_target.world_state_process_transitions,
        approval_block_target.world_state_revert_transitions,
    ):
        user_pis = MergeAndPurgeTransitionPublicInputsTarget.decode(u.public_inputs)
        MergeAndPurgeTransitionPublicInputsTarget.connect(
            builder, p.user_transaction, user_pis
        )
        MergeAndPurgeTransitionPublicInputsTarget.connect(
            builder, a.user_transaction, user_pis
        )

    received_signature_proofs = [
        RecursiveProofTarget.add_virtual_to(
            builder, simple_signature_circuit.data, in_circuit=recursive
        )
        for _ in range(n_txs)
    ]
    for r, a in zip(
        received_signature_proofs, approval_block_target.world_state_revert_transitions
    ):
        sig = SimpleSignaturePublicInputsTarget.decode(r.public_inputs)
        SimpleSignaturePublicInputsTarget.connect(builder, a.received_signature[0], sig)
        # the signature slot's enabled flag is the recursive proof's
        builder.connect(a.received_signature[1].target, r.enabled.target)

    address_list = [
        TransactionSenderWithValidityTarget(
            sender_address=p.user_transaction.sender_address,
            is_valid=a.received_signature[1],
        )
        for p, a in zip(
            proposal_block_target.world_state_process_transitions,
            approval_block_target.world_state_revert_transitions,
        )
    ]

    def to_deposit_targets(block_target):
        return [
            DepositInfoTarget(
                receiver_address=p0.new_key,
                contract_address=p1.new_key,
                variable_index=p2.new_key,
                amount=list(p2.new_value)[0],
            )
            for (p0, p1, p2) in block_target.deposit_process_proofs
        ]

    deposit_list = to_deposit_targets(deposit_block_target)
    scroll_flag_list = to_deposit_targets(scroll_block_target)
    polygon_flag_list = to_deposit_targets(polygon_block_target)

    block_number = approval_block_target.current_block_number
    builder.range_check(block_number, LOG_MAX_N_BLOCKS)
    prev_block_number = builder.sub(block_number, builder.one())
    builder.range_check(prev_block_number, LOG_MAX_N_BLOCKS)

    prev_block_header = BlockHeaderTarget(
        block_number=prev_block_number,
        block_headers_digest=builder.add_virtual_hash(),
        transactions_digest=builder.add_virtual_hash(),
        deposit_digest=builder.add_virtual_hash(),
        proposed_world_state_digest=builder.add_virtual_hash(),
        approved_world_state_digest=proposal_block_target.old_world_state_root,
        latest_account_digest=approval_block_target.old_latest_account_root,
    )
    prev_block_headers_proof_siblings = builder.add_virtual_hashes(LOG_MAX_N_BLOCKS)
    block_headers_proof = calc_block_headers_proof(
        builder, prev_block_headers_proof_siblings, prev_block_header
    )

    default_hash = builder.zero_hash()
    deposit_tree_leaves = [
        deposit_block_target.interior_deposit_digest,
        scroll_block_target.interior_deposit_digest,
        polygon_block_target.interior_deposit_digest,
    ]
    deposit_tree_leaves += [default_hash] * (n_txs - len(deposit_tree_leaves))
    deposit_digest = get_merkle_root_target_from_leaves(builder, deposit_tree_leaves)

    block_header = BlockHeaderTarget(
        block_number=block_number,
        block_headers_digest=block_headers_proof.root,
        transactions_digest=proposal_block_target.transactions_digest,
        deposit_digest=deposit_digest,
        proposed_world_state_digest=proposal_block_target.new_world_state_root,
        approved_world_state_digest=approval_block_target.new_world_state_root,
        latest_account_digest=approval_block_target.new_latest_account_root,
    )
    block_hash = get_block_hash_target(builder, block_header)

    public_inputs = BlockProductionPublicInputsTarget(
        address_list=address_list,
        deposit_list=deposit_list,
        scroll_flag_list=scroll_flag_list,
        polygon_flag_list=polygon_flag_list,
        old_account_tree_root=approval_block_target.old_latest_account_root,
        new_account_tree_root=approval_block_target.new_latest_account_root,
        old_world_state_root=proposal_block_target.old_world_state_root,
        new_world_state_root=approval_block_target.new_world_state_root,
        old_block_headers_root=prev_block_header.block_headers_digest,
        new_block_headers_root=block_headers_proof.root,
        block_hash=block_hash,
    )
    entry_hash = public_inputs.get_entry_hash(builder)
    builder.register_public_inputs(list(entry_hash))
    data = builder.build()

    targets = BlockProductionTarget(
        deposit_block_target=deposit_block_target,
        scroll_block_target=scroll_block_target,
        polygon_block_target=polygon_block_target,
        proposal_block_target=proposal_block_target,
        approval_block_target=approval_block_target,
        user_tx_proofs=user_tx_proofs,
        received_signature_proofs=received_signature_proofs,
        block_headers_proof=block_headers_proof,
        prev_block_header=prev_block_header,
        block_header=block_header,
    )
    return BlockProductionCircuit(data=data, targets=targets, constants=rollup_constants)
