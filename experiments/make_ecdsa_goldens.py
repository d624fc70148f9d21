#!/usr/bin/env python3
"""Make the port's ECDSA goldens from the JAX package, on the CPU.

    JAX_PLATFORMS=cpu PYTHONPATH=. python experiments/make_ecdsa_goldens.py [256|16 ...]

``256``: the JAX package's ``models/ecdsa/circuits.py::make_ecdsa_verification_circuit``
at ``n_bits = 256`` and ``CircuitConfig.standard_recursion_config()``, with the
demo binary's account and message (``bin/ecdsa_verification.py``), proved
and verified -> ``golden/ecdsa_256_standard.sha256``: the gate rows, n, the
circuit digest and the proof's hash.

``16``: the same circuit at ``n_bits = 16`` with the demo's contrived
small-exponent triple, at the ECDSA tests' tiny config
(``CircuitConfig(fri=FriConfig(num_query_rounds=6, proof_of_work_bits=4))``)
-> ``golden/ecdsa_16_test.sha256``, the same lines.

The triples come from the port's ``bin/ecdsa_verification.py::demo_triple``
(host integers only; it is the JAX binary's, checked here against the JAX
package's ``verify_message``).  A proof's hash is the sha256 of
``json.dumps(proof_to_json(proof), sort_keys=True)``.  ``256`` takes the
better part of an hour on a few CPU cores; ``16`` a few minutes.
"""

from __future__ import annotations

import hashlib
import json
import pathlib
import sys
import time

from intmax_zkp_core_tpu.engine.circuit import CircuitBuilder
from intmax_zkp_core_tpu.engine.config import CircuitConfig, FriConfig
from intmax_zkp_core_tpu.engine.serde import proof_to_json
from intmax_zkp_core_tpu.engine.witness import PartialWitness
from intmax_zkp_core_tpu.models.ecdsa.account import verify_message
from intmax_zkp_core_tpu.models.ecdsa.circuits import verify_message_circuit
from intmax_zkp_core_tpu_torch.bin.ecdsa_verification import demo_triple

GOLDEN = pathlib.Path(__file__).resolve().parent.parent / "intmax_zkp_core_tpu_torch" / "golden"

CASES = {
    "256": (256, CircuitConfig.standard_recursion_config(), "ecdsa_256_standard",
            "standard_recursion_config(), the demo binary's account and message"),
    "16": (16, CircuitConfig(fri=FriConfig(num_query_rounds=6, proof_of_work_bits=4)),
           "ecdsa_16_test",
           "CircuitConfig(fri=FriConfig(num_query_rounds=6, proof_of_work_bits=4)), the demo's "
           "contrived small-exponent triple"),
}


def proof_sha256(proof) -> str:
    return hashlib.sha256(json.dumps(proof_to_json(proof), sort_keys=True).encode()).hexdigest()


def make(case: str) -> None:
    n_bits, config, name, what = CASES[case]
    msg, sig, pk = demo_triple(n_bits)
    assert verify_message(pk, msg, sig)
    t0 = time.perf_counter()
    builder = CircuitBuilder(config)
    verify_message_circuit(builder, msg, sig[0], sig[1], pk, n_bits=n_bits)
    gate_rows = len(builder.rows)
    data = builder.build()
    build_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    proof = data.prove(PartialWitness())
    prove_s = time.perf_counter() - t0
    data.verify(proof)
    print(f"{name}: gate rows {gate_rows}, n {data.common.n}, build {build_s:.1f} s, "
          f"prove {prove_s:.1f} s", flush=True)
    limbs = " ".join(str(int(x)) for x in data.common.circuit_digest)
    lines = [
        f"# {name}: the JAX package's make_ecdsa_verification_circuit(n_bits={n_bits}) at {what}, "
        "proved with an empty PartialWitness (the triple is installed as constants); made by "
        f"experiments/make_ecdsa_goldens.py {case}; the proof's line is the sha256 of "
        "json.dumps(proof_to_json(proof), sort_keys=True)",
        f"gate_rows {gate_rows}  (rows the JAX builder emitted before build())",
        f"circuit_digest {limbs}  (common.circuit_digest of the JAX package's build; "
        f"{data.common.n} rows)",
        f"{proof_sha256(proof)}  proof",
    ]
    (GOLDEN / f"{name}.sha256").write_text("\n".join(lines) + "\n")


if __name__ == "__main__":
    for case in sys.argv[1:] or ["16", "256"]:
        make(case)
