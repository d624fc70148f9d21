"""zkDSA simple-signature circuit (reference ``src/zkdsa/circuits/mod.rs``):
PI layout [message(4), public_key(4), signature(4)]."""

from __future__ import annotations

from dataclasses import dataclass

from ...engine.circuit import CircuitBuilder, CircuitData
from ...engine.config import CircuitConfig
from ...engine.witness import PartialWitness
from ...utils.hash_out import HashOut
from ...utils.poseidon_host import two_to_one
from .gadgets import SimpleSignatureTarget


@dataclass
class SimpleSignaturePublicInputs:
    """``circuits/mod.rs:55-180``."""

    message: HashOut
    public_key: HashOut
    signature: HashOut

    @classmethod
    def default(cls) -> "SimpleSignaturePublicInputs":
        sk = HashOut.ZERO
        pk = two_to_one(sk, sk)
        return cls(message=HashOut.ZERO, public_key=pk, signature=two_to_one(sk, HashOut.ZERO))

    def encode(self) -> list[int]:
        out: list[int] = []
        self.message.write(out)
        self.public_key.write(out)
        self.signature.write(out)
        assert len(out) == 12
        return out

    @classmethod
    def decode(cls, public_inputs: list[int]) -> "SimpleSignaturePublicInputs":
        assert len(public_inputs) == 12
        return cls(
            message=HashOut(tuple(public_inputs[0:4])),
            public_key=HashOut(tuple(public_inputs[4:8])),
            signature=HashOut(tuple(public_inputs[8:12])),
        )

    def to_json(self) -> dict:
        return {
            "message": self.message.to_hex(),
            "public_key": self.public_key.to_hex(),
            "signature": self.signature.to_hex(),
        }


@dataclass
class SimpleSignaturePublicInputsTarget:
    """Target-side PI bundle (``circuits/mod.rs:244-311``) — plain virtual
    targets, no constraints."""

    message: object
    public_key: object
    signature: object

    @classmethod
    def add_virtual_to(cls, builder) -> "SimpleSignaturePublicInputsTarget":
        return cls(
            message=builder.add_virtual_hash(),
            public_key=builder.add_virtual_hash(),
            signature=builder.add_virtual_hash(),
        )

    def set_witness(self, pw, value: "SimpleSignaturePublicInputs") -> None:
        pw.set_hash_target(self.message, value.message)
        pw.set_hash_target(self.public_key, value.public_key)
        pw.set_hash_target(self.signature, value.signature)

    def encode(self) -> list:
        return list(self.message) + list(self.public_key) + list(self.signature)

    @classmethod
    def decode(cls, targets: list) -> "SimpleSignaturePublicInputsTarget":
        from ...engine.circuit import HashOutTarget

        assert len(targets) == 12
        return cls(
            message=HashOutTarget(tuple(targets[0:4])),
            public_key=HashOutTarget(tuple(targets[4:8])),
            signature=HashOutTarget(tuple(targets[8:12])),
        )

    @staticmethod
    def connect(builder, a, b) -> None:
        for x, y in zip(a.encode(), b.encode()):
            builder.connect(x, y)


@dataclass
class SimpleSignatureCircuit:
    data: CircuitData
    targets: SimpleSignatureTarget

    def prove(self, private_key: HashOut, message: HashOut, **prove_options):
        pw = PartialWitness()
        self.targets.set_witness(pw, private_key, message)
        return self.data.prove(pw, **prove_options)

    def verify(self, proof) -> None:
        self.data.verify(proof)

    @staticmethod
    def public_inputs(proof) -> SimpleSignaturePublicInputs:
        return SimpleSignaturePublicInputs.decode(proof.public_inputs)


def make_simple_signature_circuit(
    config: CircuitConfig | None = None, device=None
) -> SimpleSignatureCircuit:
    """``circuits/mod.rs:24-53``.  ``device=None`` builds (and later proves)
    on the CUDA device and raises when there is none."""
    builder = CircuitBuilder(config or CircuitConfig.standard_recursion_config(), device)
    targets = SimpleSignatureTarget.add_virtual_to(builder)
    builder.register_public_inputs(list(targets.message))
    builder.register_public_inputs(list(targets.public_key))
    builder.register_public_inputs(list(targets.signature))
    data = builder.build()
    return SimpleSignatureCircuit(data=data, targets=targets)
