"""Deposit-block gadget and deposit data types (reference
``src/rollup/gadgets/deposit_block/mod.rs``).

The circuit chains ``n_deposits`` 3-level insert-proof triples into the
``interior_deposit_digest`` with layered connections; it is instantiated 3x
in the block circuit for the deposit/scroll/polygon bridges."""

from __future__ import annotations

from dataclasses import dataclass

from ....engine.circuit import CircuitBuilder, HashOutTarget
from ....utils.hash_out import HashOut
from ...sparse_merkle_tree.gadgets.common import enforce_equal_if_enabled
from ...sparse_merkle_tree.gadgets.process import (
    SparseMerkleProcessProofTarget,
    get_process_merkle_proof_role,
    verify_layered_smt_target_connection,
    verify_smt_transition,
)
from ...sparse_merkle_tree.proofs import ProcessMerkleProofRole, SparseMerkleProcessProof
from ...zkdsa.account import Address
from ...zkdsa.account_gadgets import AddressTarget

P = 0xFFFFFFFF00000001


@dataclass(frozen=True)
class VariableIndex:
    """u8 index with 0x-hex serde (``deposit_block/mod.rs:27-130``)."""

    value: int

    def __post_init__(self):
        object.__setattr__(self, "value", int(self.value) & 0xFF)

    def to_hash_out(self) -> HashOut:
        return HashOut((self.value, 0, 0, 0))

    @classmethod
    def from_hash_out(cls, h: HashOut) -> "VariableIndex":
        return cls(h.elements[0] & 0xFF)

    def to_hex(self) -> str:
        return "0x" + bytes([self.value]).hex()

    @classmethod
    def from_hex(cls, s: str) -> "VariableIndex":
        assert s.startswith("0x")
        return cls(bytes.fromhex(s[2:])[0])

    def write(self, out: list[int]) -> None:
        out.extend([self.value, 0, 0, 0])

    @classmethod
    def read(cls, it) -> "VariableIndex":
        v = next(it)
        for _ in range(3):
            next(it)
        return cls(v & 0xFF)


@dataclass(frozen=True)
class DepositInfo:
    """``deposit_block/mod.rs:142-149``."""

    receiver_address: Address
    contract_address: Address
    variable_index: VariableIndex
    amount: int

    def to_json(self) -> dict:
        return {
            "receiver_address": self.receiver_address.to_hex(),
            "contract_address": self.contract_address.to_hex(),
            "variable_index": self.variable_index.to_hex(),
            "amount": self.amount,
        }

    @classmethod
    def from_json(cls, o: dict) -> "DepositInfo":
        return cls(
            receiver_address=Address.from_hex(o["receiver_address"]),
            contract_address=Address.from_hex(o["contract_address"]),
            variable_index=VariableIndex.from_hex(o["variable_index"]),
            amount=int(o["amount"]),
        )


@dataclass
class DepositInfoTarget:
    receiver_address: AddressTarget
    contract_address: AddressTarget
    variable_index: HashOutTarget
    amount: int  # target

    @classmethod
    def add_virtual_to(cls, builder: CircuitBuilder) -> "DepositInfoTarget":
        return cls(
            receiver_address=AddressTarget.add_virtual_to(builder),
            contract_address=AddressTarget.add_virtual_to(builder),
            variable_index=builder.add_virtual_hash(),
            amount=builder.add_virtual_target(),
        )

    def set_witness(self, pw, value: DepositInfo) -> None:
        self.receiver_address.set_witness(pw, value.receiver_address)
        self.contract_address.set_witness(pw, value.contract_address)
        pw.set_hash_target(self.variable_index, value.variable_index.to_hash_out())
        pw.set_target(self.amount, value.amount % P)


DepositTriple = tuple[
    SparseMerkleProcessProofTarget,
    SparseMerkleProcessProofTarget,
    SparseMerkleProcessProofTarget,
]


@dataclass
class DepositBlockProductionTarget:
    """``deposit_block/mod.rs:205-351``."""

    deposit_process_proofs: list[DepositTriple]
    interior_deposit_digest: HashOutTarget  # output
    log_n_recipients: int
    log_n_kinds: int

    @classmethod
    def add_virtual_to(
        cls,
        builder: CircuitBuilder,
        log_n_recipients: int,
        log_n_contracts: int,
        log_n_variables: int,
        n_deposits: int,
    ) -> "DepositBlockProductionTarget":
        proofs = [
            (
                SparseMerkleProcessProofTarget.add_virtual_to(builder, log_n_recipients),
                SparseMerkleProcessProofTarget.add_virtual_to(builder, log_n_contracts),
                SparseMerkleProcessProofTarget.add_virtual_to(builder, log_n_variables),
            )
            for _ in range(n_deposits)
        ]
        interior_deposit_digest = calc_deposit_digest(builder, proofs)
        return cls(
            deposit_process_proofs=proofs,
            interior_deposit_digest=interior_deposit_digest,
            log_n_recipients=log_n_recipients,
            log_n_kinds=log_n_contracts + log_n_variables,
        )

    def set_witness(self, pw, deposit_process_proofs) -> HashOut:
        """Returns the interior deposit digest."""
        assert len(deposit_process_proofs) <= len(self.deposit_process_proofs)
        interior_deposit_digest = HashOut.ZERO
        from ...sparse_merkle_tree.layered import verify_layered_smt_connection

        for (p0, p1, p2), (w0, w1, w2) in zip(
            self.deposit_process_proofs, deposit_process_proofs
        ):
            assert w0.old_root == interior_deposit_digest
            verify_layered_smt_connection(
                w0.fnc, w0.old_value, w0.new_value, w1.old_root, w1.new_root
            )
            verify_layered_smt_connection(
                w1.fnc, w1.old_value, w1.new_value, w2.old_root, w2.new_root
            )
            assert w2.fnc == ProcessMerkleProofRole.ProcessInsert
            p0.set_witness(pw, w0)
            p1.set_witness(pw, w1)
            p2.set_witness(pw, w2)
            interior_deposit_digest = w0.new_root

        default = SparseMerkleProcessProof.with_root(interior_deposit_digest)
        default_zero = SparseMerkleProcessProof.with_root(HashOut.ZERO)
        for p0, p1, p2 in self.deposit_process_proofs[len(deposit_process_proofs):]:
            p0.set_witness(pw, default)
            p1.set_witness(pw, default_zero)
            p2.set_witness(pw, default_zero)
        return interior_deposit_digest


def calc_deposit_digest(
    builder: CircuitBuilder, deposit_process_proofs: list[DepositTriple]
) -> HashOutTarget:
    """``deposit_block/mod.rs:311-351``: chain layered triples with hard
    root connections; layer-2 op must be insert or noop."""
    prev = builder.zero_hash()
    for p0, p1, p2 in deposit_process_proofs:
        role2 = get_process_merkle_proof_role(builder, p2.fnc)
        builder.assert_one(role2.is_insert_or_no_op.target)
        verify_layered_smt_target_connection(
            builder, p0.fnc, p0.old_value, p0.new_value, p1.old_root, p1.new_root
        )
        verify_layered_smt_target_connection(
            builder, p1.fnc, p1.old_value, p1.new_value, p2.old_root, p2.new_root
        )
        builder.connect_hashes(p0.old_root, prev)
        prev = p0.new_root
    return prev
