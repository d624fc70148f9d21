#!/usr/bin/env python3
"""Make the port's golden of the two-process proof axis from the JAX package,
on the CPU.

    JAX_PLATFORMS=cpu PYTHONPATH=. python experiments/make_distributed_goldens.py

The four zkDSA witnesses of ``tests/test_distributed.py`` (key 101 + i,
message 7 + i, ``CircuitConfig(fri=FriConfig(num_query_rounds=3,
proof_of_work_bits=2))``), each proved by the JAX package's ``prove`` (which
that test holds its two-process proofs equal to) ->
``golden/zkdsa_distributed_test.sha256``: the circuit's digest and the four
proof hashes.  A proof's hash is the sha256 of
``json.dumps(proof_to_json(proof), sort_keys=True)``, the form the port's
tests hash.  Takes about half a minute.
"""

from __future__ import annotations

import hashlib
import json
import pathlib

from intmax_zkp_core_tpu.engine.config import CircuitConfig, FriConfig
from intmax_zkp_core_tpu.engine.serde import proof_to_json
from intmax_zkp_core_tpu.engine.witness import PartialWitness
from intmax_zkp_core_tpu.models.zkdsa.circuits import make_simple_signature_circuit
from intmax_zkp_core_tpu.utils.hash_out import HashOut

GOLDEN = pathlib.Path(__file__).resolve().parent.parent / "intmax_zkp_core_tpu_torch" / "golden"


def main() -> None:
    circ = make_simple_signature_circuit(
        CircuitConfig(fri=FriConfig(num_query_rounds=3, proof_of_work_bits=2)))
    limbs = " ".join(str(int(x)) for x in circ.data.common.circuit_digest)
    lines = [
        "# zkdsa_distributed_test: the JAX package's prove of tests/test_distributed.py's four "
        "zkDSA witnesses (key 101 + i, message 7 + i) at FriConfig(num_query_rounds=3, "
        "proof_of_work_bits=2); made by experiments/make_distributed_goldens.py; a proof's "
        "line is the sha256 of json.dumps(proof_to_json(proof), sort_keys=True)",
        f"circuit_digest {limbs}  (common.circuit_digest of the JAX package's build)",
    ]
    for i in range(4):
        pw = PartialWitness()
        circ.targets.set_witness(pw, HashOut.from_u64(101 + i), HashOut.from_u64(7 + i))
        proof = circ.data.prove(pw)
        circ.data.verify(proof)
        sha = hashlib.sha256(json.dumps(proof_to_json(proof), sort_keys=True).encode()).hexdigest()
        lines.append(f"{sha}  proof {i} (key {101 + i}, message {7 + i})")
    (GOLDEN / "zkdsa_distributed_test.sha256").write_text("\n".join(lines) + "\n")
    print("\n".join(lines))


if __name__ == "__main__":
    main()
