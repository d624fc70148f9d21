"""Address list (reference ``src/rollup/address_list.rs``)."""

from __future__ import annotations

from dataclasses import dataclass

from ..zkdsa.account import Address


@dataclass(frozen=True)
class TransactionSenderWithValidity:
    sender_address: Address
    is_valid: bool

    def to_json(self) -> dict:
        return {"sender_address": self.sender_address.to_hex(), "is_valid": self.is_valid}

    @classmethod
    def from_json(cls, o: dict) -> "TransactionSenderWithValidity":
        return cls(
            sender_address=Address.from_hex(o["sender_address"]), is_valid=o["is_valid"]
        )


def make_address_list(user_tx_public_inputs, received_signatures):
    """``address_list.rs:23-43``: (sender, has-signature) per transaction."""
    assert len(user_tx_public_inputs) == len(received_signatures)
    return [
        TransactionSenderWithValidity(
            sender_address=pis.sender_address, is_valid=sig is not None
        )
        for pis, sig in zip(user_tx_public_inputs, received_signatures)
    ]
