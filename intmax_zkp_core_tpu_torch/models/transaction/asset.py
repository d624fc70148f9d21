"""Asset data model (reference ``src/transaction/asset.rs``)."""

from __future__ import annotations

from dataclasses import dataclass, field

from ...utils.hash_out import HashOut
from ..rollup.gadgets.deposit_block import DepositInfo, VariableIndex
from ..zkdsa.account import Address


@dataclass(frozen=True)
class TokenKind:
    """(contract_address, variable_index) with 32-byte LE packed codec
    (``asset.rs:48-78``)."""

    contract_address: Address
    variable_index: VariableIndex

    def to_bytes(self) -> bytes:
        out = self.contract_address.to_hash_out().to_bytes()[0:24]
        out += self.variable_index.to_hash_out().to_bytes()[0:8]
        return out.ljust(32, b"\x00")

    @classmethod
    def from_bytes(cls, data: bytes) -> "TokenKind":
        assert len(data) == 32
        contract = HashOut.from_bytes(data[0:24].ljust(32, b"\x00"))
        variable = HashOut.from_bytes(data[24:32].ljust(32, b"\x00"))
        return cls(
            contract_address=Address.from_hash_out(contract),
            variable_index=VariableIndex.from_hash_out(variable),
        )

    def to_json(self) -> dict:
        return {
            "contract_address": self.contract_address.to_hex(),
            "variable_index": self.variable_index.to_hex(),
        }

    @classmethod
    def from_json(cls, o: dict) -> "TokenKind":
        return cls(
            contract_address=Address.from_hex(o["contract_address"]),
            variable_index=VariableIndex.from_hex(o["variable_index"]),
        )


@dataclass(frozen=True)
class Asset:
    kind: TokenKind
    amount: int

    def to_json(self) -> dict:
        return {"kind": self.kind.to_json(), "amount": self.amount}


@dataclass(frozen=True)
class ContributedAsset:
    """receiver + kind + amount; interconvertible with DepositInfo
    (``asset.rs:107-160``)."""

    receiver_address: Address
    kind: TokenKind
    amount: int

    def to_deposit_info(self) -> DepositInfo:
        return DepositInfo(
            receiver_address=self.receiver_address,
            contract_address=self.kind.contract_address,
            variable_index=self.kind.variable_index,
            amount=self.amount,
        )

    @classmethod
    def from_deposit_info(cls, d: DepositInfo) -> "ContributedAsset":
        return cls(
            receiver_address=d.receiver_address,
            kind=TokenKind(
                contract_address=d.contract_address, variable_index=d.variable_index
            ),
            amount=d.amount,
        )

    def to_json(self) -> dict:
        return {
            "receiver_address": self.receiver_address.to_hex(),
            "contract_address": self.kind.contract_address.to_hex(),
            "variable_index": self.kind.variable_index.to_hex(),
            "amount": self.amount,
        }

    @classmethod
    def from_json(cls, o: dict) -> "ContributedAsset":
        return cls(
            receiver_address=Address.from_hex(o["receiver_address"]),
            kind=TokenKind(
                contract_address=Address.from_hex(o["contract_address"]),
                variable_index=VariableIndex.from_hex(o["variable_index"]),
            ),
            amount=int(o["amount"]),
        )


@dataclass
class ReceivedAssetProof:
    """``asset.rs:192-204``."""

    is_deposit: bool
    diff_tree_inclusion_proof: tuple  # (BlockHeader, MerkleProof, SmtInclusionProof)
    latest_account_tree_inclusion_proof: object
    assets: list[Asset] = field(default_factory=list)
    nonce: HashOut = HashOut.ZERO
