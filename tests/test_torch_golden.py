"""The stored golden hash of the zkDSA proof at
``standard_recursion_config`` is what the JAX package produces, and the port
reproduces it on the CPU.  ``chip_smoke.py`` holds the proof made on the GPU
against the same file."""

import hashlib
import json
import pathlib

import torch

GOLDEN = (
    pathlib.Path(__file__).resolve().parent.parent
    / "intmax_zkp_core_tpu_torch" / "golden" / "zkdsa_standard.sha256"
)

torch.set_num_threads(1)


def _sha(proof_json) -> str:
    return hashlib.sha256(json.dumps(proof_json, sort_keys=True).encode()).hexdigest()


def test_jax_package_reproduces_golden():
    from intmax_zkp_core_tpu.engine.config import CircuitConfig
    from intmax_zkp_core_tpu.engine.serde import proof_to_json
    from intmax_zkp_core_tpu.models.zkdsa import make_simple_signature_circuit
    from intmax_zkp_core_tpu.utils.hash_out import HashOut

    circuit = make_simple_signature_circuit(CircuitConfig.standard_recursion_config())
    proof = circuit.prove(HashOut.from_u64(42), HashOut.from_u64(0xABCDEF))
    assert _sha(proof_to_json(proof)) == GOLDEN.read_text().split()[0]


def test_port_reproduces_golden_on_cpu():
    from intmax_zkp_core_tpu_torch.engine.config import CircuitConfig
    from intmax_zkp_core_tpu_torch.engine.serde import proof_from_json, proof_to_json
    from intmax_zkp_core_tpu_torch.models.zkdsa import make_simple_signature_circuit
    from intmax_zkp_core_tpu_torch.utils.hash_out import HashOut

    circuit = make_simple_signature_circuit(CircuitConfig.standard_recursion_config(), device="cpu")
    proof = circuit.prove(HashOut.from_u64(42), HashOut.from_u64(0xABCDEF))
    assert _sha(proof_to_json(proof)) == GOLDEN.read_text().split()[0]
    # the JSON form round-trips and still verifies
    again = proof_from_json(json.loads(json.dumps(proof_to_json(proof))))
    circuit.verify(again)
