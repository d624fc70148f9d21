"""Proving many independent witnesses of one circuit.

The user-transaction and signature proofs that a block circuit verifies are
independent to generate.  ``prove_many`` proves a list of them in one batch
(``engine/prover.py::prove_batch``), with the proof axis over a mesh of
devices when one is given or, as in the JAX package, when more than one
CUDA device is attached (``parallel/mesh.py::default_mesh``).  The JAX
package's other rule -- a batch on an accelerator, a pipelined loop of
single proofs on the CPU -- has nothing to choose here, where ``prove`` is
``prove_batch`` at K = 1.
"""

from __future__ import annotations

from ..engine.prover import prove_batch
from ..engine.witness import PartialWitness
from .mesh import default_mesh


def prove_many(circuit, set_witness_fns: list, mesh=None, **prove_options) -> list:
    """Prove independent witnesses on one circuit: ``set_witness_fns`` are
    callables ``f(pw) -> None`` filling a PartialWitness for each proof;
    ``mesh`` shards the proof axis (``None``: ``default_mesh`` of the
    proving device); ``prove_options`` (``device``, ``fused_sponge``,
    ``timings``) go to ``prove_batch``.  The proofs are bit-identical to
    sequential ones."""
    if not set_witness_fns:
        return []
    pws = []
    for fn in set_witness_fns:
        pw = PartialWitness()
        fn(pw)
        pws.append(pw)
    if mesh is None:
        mesh = default_mesh(prove_options.get("device") or circuit.data.device, len(pws))
    if mesh is not None:
        prove_options.pop("device", None)
    return prove_batch(circuit.data, pws, mesh=mesh, **prove_options)
