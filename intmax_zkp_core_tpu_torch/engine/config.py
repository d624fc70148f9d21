"""Engine configuration (the counterpart of plonky2's ``CircuitConfig``;
the reference always uses ``standard_recursion_config``, e.g.
``bin/block_circuit.rs:76``)."""

from __future__ import annotations

from dataclasses import dataclass, field


@dataclass(frozen=True)
class FriConfig:
    rate_bits: int = 3  # blowup 8
    cap_height: int = 4
    num_query_rounds: int = 28
    proof_of_work_bits: int = 16
    # fold by 2 until the (virtual) polynomial length reaches this bound,
    # then ship coefficients directly
    final_poly_len: int = 32

    @property
    def blowup(self) -> int:
        return 1 << self.rate_bits


@dataclass(frozen=True)
class CircuitConfig:
    num_wires: int = 135
    num_routed_wires: int = 80
    num_challenges: int = 2
    max_degree: int = 8  # max filtered-constraint degree == quotient factor
    fri: FriConfig = field(default_factory=FriConfig)

    @classmethod
    def standard_recursion_config(cls) -> "CircuitConfig":
        return cls()

    @classmethod
    def test_config(cls) -> "CircuitConfig":
        """Cheaper FRI for unit tests (still sound, lower security margin)."""
        return cls(fri=FriConfig(num_query_rounds=8, proof_of_work_bits=8))
