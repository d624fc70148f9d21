"""A Poseidon hash-chain circuit: ``digest = H(H(...H(seed, salt)..., salt), salt)``.

One Poseidon gate row per link, built through the ordinary ``CircuitBuilder``
surface (``two_to_one``), so it exercises the same builder / prover /
verifier path as the application circuits at any height: ``log_rows=15``
gives the 32768-row height of the block circuit.  Public inputs:
``[seed(4), salt(4), digest(4)]``.
"""

from __future__ import annotations

from dataclasses import dataclass

from ..engine.circuit import CircuitBuilder, CircuitData, HashOutTarget
from ..engine.config import CircuitConfig
from ..engine.witness import PartialWitness
from ..utils.hash_out import HashOut

# rows besides the links: one constant row, two rows of the public-input
# hash sponge (12 inputs), the public-input row
_OVERHEAD_ROWS = 4


@dataclass
class HashChainCircuit:
    data: CircuitData
    seed: HashOutTarget
    salt: HashOutTarget
    num_links: int

    def witness(self, seed: HashOut, salt: HashOut) -> PartialWitness:
        pw = PartialWitness()
        pw.set_hash_target(self.seed, seed.elements)
        pw.set_hash_target(self.salt, salt.elements)
        return pw

    def prove(self, seed: HashOut, salt: HashOut, **prove_options):
        return self.data.prove(self.witness(seed, salt), **prove_options)

    def verify(self, proof) -> None:
        self.data.verify(proof)


def links_for_rows(log_rows: int) -> int:
    """Number of links that fills exactly 2^log_rows rows."""
    return (1 << log_rows) - _OVERHEAD_ROWS


def make_hash_chain_circuit(
    num_links: int, config: CircuitConfig | None = None, device=None
) -> HashChainCircuit:
    builder = CircuitBuilder(config or CircuitConfig.standard_recursion_config(), device)
    seed = builder.add_virtual_hash()
    salt = builder.add_virtual_hash()
    cur = seed
    for _ in range(num_links):
        cur = builder.two_to_one(cur, salt)
    builder.register_public_inputs(list(seed))
    builder.register_public_inputs(list(salt))
    builder.register_public_inputs(list(cur))
    return HashChainCircuit(data=builder.build(), seed=seed, salt=salt, num_links=num_links)
