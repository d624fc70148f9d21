"""zkDSA signature gadget (reference ``src/zkdsa/gadgets/signature/mod.rs``):
``public_key = Poseidon(sk || sk)``, ``signature = Poseidon(sk || msg)``."""

from __future__ import annotations

from dataclasses import dataclass

from ...engine.circuit import CircuitBuilder, HashOutTarget
from ...engine.witness import PartialWitness
from ...utils.hash_out import HashOut


def verify_simple_signature(
    builder: CircuitBuilder, private_key: HashOutTarget, message: HashOutTarget
) -> tuple[HashOutTarget, HashOutTarget]:
    """Returns (signature, public_key) (``signature/mod.rs:50-63``)."""
    public_key = builder.two_to_one(private_key, private_key)
    signature = builder.two_to_one(private_key, message)
    return signature, public_key


@dataclass
class SimpleSignatureTarget:
    private_key: HashOutTarget
    public_key: HashOutTarget
    message: HashOutTarget
    signature: HashOutTarget

    @classmethod
    def add_virtual_to(cls, builder: CircuitBuilder) -> "SimpleSignatureTarget":
        private_key = builder.add_virtual_hash()
        message = builder.add_virtual_hash()
        signature, public_key = verify_simple_signature(builder, private_key, message)
        return cls(
            private_key=private_key,
            public_key=public_key,
            message=message,
            signature=signature,
        )

    def set_witness(self, pw: PartialWitness, private_key: HashOut, message: HashOut) -> None:
        pw.set_hash_target(self.private_key, private_key)
        pw.set_hash_target(self.message, message)
