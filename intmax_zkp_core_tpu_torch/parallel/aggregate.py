"""Proving many independent witnesses of one circuit.

The user-transaction and signature proofs that a block circuit verifies are
independent to generate.  ``prove_many`` proves a list of them in one batch
(``engine/prover.py::prove_batch``).  The JAX package's rule -- a batch on
an accelerator, a pipelined loop of single proofs on the CPU -- has nothing
to choose here, where ``prove`` is ``prove_batch`` at K = 1.
"""

from __future__ import annotations

from ..engine.prover import prove_batch
from ..engine.witness import PartialWitness


def prove_many(circuit, set_witness_fns: list, **prove_options) -> list:
    """Prove independent witnesses on one circuit: ``set_witness_fns`` are
    callables ``f(pw) -> None`` filling a PartialWitness for each proof;
    ``prove_options`` (``device``, ``fused_sponge``, ``timings``) go to
    ``prove_batch``.  The proofs are bit-identical to sequential ones."""
    if not set_witness_fns:
        return []
    pws = []
    for fn in set_witness_fns:
        pw = PartialWitness()
        fn(pw)
        pws.append(pw)
    return prove_batch(circuit.data, pws, **prove_options)
