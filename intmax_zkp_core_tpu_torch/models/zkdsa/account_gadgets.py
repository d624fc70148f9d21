"""AddressTarget: 4-limb digest with upper limbs pinned to zero (reference
``src/zkdsa/gadgets/account/mod.rs``)."""

from __future__ import annotations

from dataclasses import dataclass

from ...engine.circuit import CircuitBuilder, HashOutTarget
from .account import Address


@dataclass(frozen=True)
class AddressTarget:
    hash_out: HashOutTarget

    @classmethod
    def add_virtual_to(cls, builder: CircuitBuilder) -> "AddressTarget":
        target = builder.add_virtual_hash()
        zero = builder.zero()
        for i in (1, 2, 3):
            builder.connect(list(target)[i], zero)
        return cls(target)

    def set_witness(self, pw, value: Address) -> None:
        pw.set_hash_target(self.hash_out, value.to_hash_out())

    def __iter__(self):
        return iter(self.hash_out)
