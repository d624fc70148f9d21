"""User-transaction (merge + purge) circuit (reference
``src/transaction/circuits/mod.rs``): composes the merge and purge
transitions, computes ``tx_hash = Poseidon(diff_root || nonce)``, 24-element
PI layout."""

from __future__ import annotations

from dataclasses import dataclass

from ...config import RollupConstants
from ...engine.circuit import CircuitBuilder, CircuitData
from ...engine.config import CircuitConfig
from ...engine.witness import PartialWitness
from ...utils.hash_out import HashOut
from ...utils.poseidon_host import two_to_one
from ..sparse_merkle_tree.gadgets.common import poseidon_two_to_one
from ..zkdsa.account import Address
from .gadgets.merge import MergeProof, MergeTransitionTarget
from .gadgets.purge import PurgeTransitionTarget


@dataclass
class MergeAndPurgeTransition:
    """Witness bundle (``circuits/mod.rs:38-47``)."""

    sender_address: Address
    merge_witnesses: list[MergeProof]
    purge_input_witnesses: list
    purge_output_witnesses: list
    nonce: HashOut
    old_user_asset_root: HashOut


@dataclass
class MergeAndPurgeTransitionPublicInputs:
    """``circuits/mod.rs:176-273``."""

    sender_address: Address
    old_user_asset_root: HashOut
    middle_user_asset_root: HashOut
    new_user_asset_root: HashOut
    diff_root: HashOut
    tx_hash: HashOut

    @classmethod
    def default(cls) -> "MergeAndPurgeTransitionPublicInputs":
        diff_root = HashOut.ZERO
        nonce = HashOut.ZERO
        return cls(
            sender_address=Address(0),
            old_user_asset_root=HashOut.ZERO,
            middle_user_asset_root=HashOut.ZERO,
            new_user_asset_root=HashOut.ZERO,
            diff_root=diff_root,
            tx_hash=two_to_one(diff_root, nonce),
        )

    def encode(self) -> list[int]:
        out: list[int] = []
        self.old_user_asset_root.write(out)
        self.middle_user_asset_root.write(out)
        self.new_user_asset_root.write(out)
        self.diff_root.write(out)
        self.sender_address.write(out)
        self.tx_hash.write(out)
        assert len(out) == 24
        return out

    @classmethod
    def decode(cls, public_inputs: list[int]) -> "MergeAndPurgeTransitionPublicInputs":
        assert len(public_inputs) == 24
        assert public_inputs[17] == 0 and public_inputs[18] == 0 and public_inputs[19] == 0
        return cls(
            old_user_asset_root=HashOut(tuple(public_inputs[0:4])),
            middle_user_asset_root=HashOut(tuple(public_inputs[4:8])),
            new_user_asset_root=HashOut(tuple(public_inputs[8:12])),
            diff_root=HashOut(tuple(public_inputs[12:16])),
            sender_address=Address(public_inputs[16]),
            tx_hash=HashOut(tuple(public_inputs[20:24])),
        )


@dataclass
class MergeAndPurgeTransitionPublicInputsTarget:
    """Target-side PI bundle (``circuits/mod.rs:276-379``) — virtual targets
    with the Address upper limbs unconstrained (set to zero by witness)."""

    sender_address: object  # HashOutTarget (4 limbs)
    old_user_asset_root: object
    middle_user_asset_root: object
    new_user_asset_root: object
    diff_root: object
    tx_hash: object

    @classmethod
    def add_virtual_to(cls, builder) -> "MergeAndPurgeTransitionPublicInputsTarget":
        return cls(
            sender_address=builder.add_virtual_hash(),
            old_user_asset_root=builder.add_virtual_hash(),
            middle_user_asset_root=builder.add_virtual_hash(),
            new_user_asset_root=builder.add_virtual_hash(),
            diff_root=builder.add_virtual_hash(),
            tx_hash=builder.add_virtual_hash(),
        )

    def set_witness(self, pw, value: "MergeAndPurgeTransitionPublicInputs") -> None:
        pw.set_hash_target(self.sender_address, value.sender_address.to_hash_out())
        pw.set_hash_target(self.old_user_asset_root, value.old_user_asset_root)
        pw.set_hash_target(self.middle_user_asset_root, value.middle_user_asset_root)
        pw.set_hash_target(self.new_user_asset_root, value.new_user_asset_root)
        pw.set_hash_target(self.diff_root, value.diff_root)
        pw.set_hash_target(self.tx_hash, value.tx_hash)

    def encode(self) -> list:
        return (
            list(self.old_user_asset_root)
            + list(self.middle_user_asset_root)
            + list(self.new_user_asset_root)
            + list(self.diff_root)
            + list(self.sender_address)
            + list(self.tx_hash)
        )

    @classmethod
    def decode(cls, targets: list) -> "MergeAndPurgeTransitionPublicInputsTarget":
        """Reconstruct the PI bundle from a flat 24-target list (the inner
        proof's registered PI order, ``circuits/mod.rs:381-420``)."""
        from ...engine.circuit import HashOutTarget

        assert len(targets) == 24
        return cls(
            old_user_asset_root=HashOutTarget(tuple(targets[0:4])),
            middle_user_asset_root=HashOutTarget(tuple(targets[4:8])),
            new_user_asset_root=HashOutTarget(tuple(targets[8:12])),
            diff_root=HashOutTarget(tuple(targets[12:16])),
            sender_address=HashOutTarget(tuple(targets[16:20])),
            tx_hash=HashOutTarget(tuple(targets[20:24])),
        )

    @staticmethod
    def connect(builder, a, b) -> None:
        for x, y in zip(a.encode(), b.encode()):
            builder.connect(x, y)


@dataclass
class MergeAndPurgeTransitionTarget:
    merge_proof_target: MergeTransitionTarget
    purge_proof_target: PurgeTransitionTarget

    def set_witness(
        self,
        pw: PartialWitness,
        sender_address: Address,
        merge_witnesses: list[MergeProof],
        purge_input_witnesses: list,
        purge_output_witnesses: list,
        nonce: HashOut,
        old_user_asset_root: HashOut,
    ) -> MergeAndPurgeTransitionPublicInputs:
        middle = self.merge_proof_target.set_witness(pw, merge_witnesses, old_user_asset_root)
        new_root, diff_root, tx_hash = self.purge_proof_target.set_witness(
            pw, sender_address, purge_input_witnesses, purge_output_witnesses, middle, nonce
        )
        return MergeAndPurgeTransitionPublicInputs(
            sender_address=sender_address,
            old_user_asset_root=old_user_asset_root,
            middle_user_asset_root=middle,
            new_user_asset_root=new_root,
            diff_root=diff_root,
            tx_hash=tx_hash,
        )


@dataclass
class MergeAndPurgeTransitionCircuit:
    data: CircuitData
    targets: MergeAndPurgeTransitionTarget

    def witness(self, transition: MergeAndPurgeTransition):
        """The partial witness of ``transition`` and the public inputs it
        must give."""
        pw = PartialWitness()
        expected = self.targets.set_witness(
            pw,
            transition.sender_address,
            transition.merge_witnesses,
            transition.purge_input_witnesses,
            transition.purge_output_witnesses,
            transition.nonce,
            transition.old_user_asset_root,
        )
        return pw, expected

    def prove_transition(self, transition: MergeAndPurgeTransition, **prove_options):
        pw, expected = self.witness(transition)
        proof = self.data.prove(pw, **prove_options)
        got = MergeAndPurgeTransitionPublicInputs.decode(proof.public_inputs)
        assert got == expected, "public inputs mismatch"
        return proof

    def verify(self, proof) -> None:
        self.data.verify(proof)

    @staticmethod
    def public_inputs(proof) -> MergeAndPurgeTransitionPublicInputs:
        return MergeAndPurgeTransitionPublicInputs.decode(proof.public_inputs)


def prove_user_transaction(
    rollup_constants: RollupConstants,
    transition: MergeAndPurgeTransition,
    config: CircuitConfig | None = None,
    device=None,
):
    """One-shot build + prove + verify (``circuits/mod.rs:496-532``).
    Returns (circuit, proof)."""
    circuit = make_user_proof_circuit(rollup_constants, config, device)
    proof = circuit.prove_transition(transition)
    circuit.verify(proof)
    return circuit, proof


def make_user_proof_circuit(
    rollup_constants: RollupConstants, config: CircuitConfig | None = None, device=None
) -> MergeAndPurgeTransitionCircuit:
    """``circuits/mod.rs:89-168``.  ``device=None`` builds (and later proves)
    on the CUDA device and raises when there is none."""
    builder = CircuitBuilder(config or CircuitConfig.standard_recursion_config(), device)
    merge_target = MergeTransitionTarget.add_virtual_to(
        builder,
        rollup_constants.log_max_n_users,
        rollup_constants.log_max_n_txs,
        rollup_constants.log_n_txs,
        rollup_constants.log_n_recipients,
        rollup_constants.n_merges,
    )
    purge_target = PurgeTransitionTarget.add_virtual_to(
        builder,
        rollup_constants.log_max_n_txs,
        rollup_constants.log_max_n_contracts,
        rollup_constants.log_max_n_variables,
        rollup_constants.log_n_recipients,
        rollup_constants.log_n_contracts,
        rollup_constants.log_n_variables,
        rollup_constants.n_diffs,
    )
    builder.connect_hashes(merge_target.new_user_asset_root, purge_target.old_user_asset_root)

    tx_hash = poseidon_two_to_one(builder, purge_target.diff_root, purge_target.nonce)

    builder.register_public_inputs(list(merge_target.old_user_asset_root))  # [0..4]
    builder.register_public_inputs(list(merge_target.new_user_asset_root))  # [4..8]
    builder.register_public_inputs(list(purge_target.new_user_asset_root))  # [8..12]
    builder.register_public_inputs(list(purge_target.diff_root))  # [12..16]
    builder.register_public_inputs(list(purge_target.sender_address))  # [16..20]
    builder.register_public_inputs(list(tx_hash))  # [20..24]

    data = builder.build()
    return MergeAndPurgeTransitionCircuit(
        data=data,
        targets=MergeAndPurgeTransitionTarget(
            merge_proof_target=merge_target, purge_proof_target=purge_target
        ),
    )
