"""Recursive proof wrapping (reference ``src/recursion/gadgets/mod.rs``).

Reference semantics preserved: the inner circuit's verifier data
(constants_sigmas_cap + circuit_digest) is baked as *constants* of the
outer circuit, the inner proof is verified in-circuit, and ``enabled`` is a
witness-only flag (disabled slots still carry *valid* default proofs —
``recursion/gadgets/mod.rs:85-127``).

``in_circuit=True`` (default) runs the engine's full in-circuit verifier
(``engine/recursion.py``: transcript replay, vanishing/quotient identity at
zeta, FRI queries).  ``in_circuit=False`` is the trusted-aggregation mode:
the same PI surface, but the inner proof is verified by the HOST verifier
inside ``set_witness`` — used to keep very large test circuits fast; the
soundness trade-off is documented at each call site.
"""

from __future__ import annotations

from dataclasses import dataclass

from ...engine import recursion as rec
from ...engine.circuit import BoolTarget, CircuitBuilder, CircuitData
from ...engine.verifier import verify


@dataclass
class CheckedPublicInputs:
    """Public inputs of an inner circuit validated via
    ``CircuitData.check_witness`` (constraints evaluated, no FRI proof).
    Accepted in trusted-aggregation mode for fast integration tests only."""

    public_inputs: list


@dataclass
class RecursiveProofTarget:
    public_inputs: list[int]  # targets mirroring the inner proof's PIs
    enabled: BoolTarget
    inner_common: object  # inner CommonCircuitData (host verification key)
    proof_target: object  # engine ProofTarget when in_circuit, else None

    @classmethod
    def add_virtual_to(
        cls, builder: CircuitBuilder, circuit_data: CircuitData, in_circuit: bool = True
    ):
        common = circuit_data.common
        # commit to WHICH circuit is being aggregated
        # (recursion/gadgets/mod.rs:85-100)
        builder.constant_hash(common.circuit_digest)
        for digest in common.constants_sigmas_cap:
            builder.constant_hash(digest)
        enabled = builder.add_virtual_bool_target_safe()
        if in_circuit:
            pt = rec.add_virtual_proof_target(builder, common)
            rec.verify_proof_in_circuit(builder, common, pt)
            return cls(
                public_inputs=pt.public_inputs,
                enabled=enabled,
                inner_common=common,
                proof_target=pt,
            )
        pis = builder.add_virtual_targets(common.num_public_inputs)
        return cls(
            public_inputs=pis, enabled=enabled, inner_common=common, proof_target=None
        )

    def set_witness(self, pw, proof, enabled: bool) -> None:
        if self.proof_target is not None:
            assert not isinstance(proof, CheckedPublicInputs), (
                "in-circuit recursion requires a real proof"
            )
            rec.set_proof_target_witness(pw, self.proof_target, proof)
        else:
            # trusted-aggregation mode: host-verify the inner proof (valid
            # default proofs are still required for disabled slots)
            if not isinstance(proof, CheckedPublicInputs):
                verify(self.inner_common, proof)
            assert len(proof.public_inputs) == len(self.public_inputs)
            for t, v in zip(self.public_inputs, proof.public_inputs):
                pw.set_target(t, v)
        pw.set_bool_target(self.enabled, enabled)
