"""What the benchmark reads off the program's outputs and circuits: a proof
as plain lists of integers (what the reference verifier reads), the
verifier key, a circuit's shape."""

from __future__ import annotations


def _cap(cap):
    return [[int(x) for x in d] for d in cap]


def plain(proof) -> dict:
    return {
        "wires_cap": _cap(proof.wires_cap),
        "zs_pp_cap": _cap(proof.zs_pp_cap),
        "quotient_cap": _cap(proof.quotient_cap),
        "openings": {k: [[int(a), int(b)] for a, b in v] for k, v in proof.openings.items()},
        "fri": {
            "caps": [_cap(c) for c in proof.fri.caps],
            "final_poly": [[int(a), int(b)] for a, b in proof.fri.final_poly],
            "pow_witness": int(proof.fri.pow_witness),
            "query_rounds": [[[[int(v) for v in leaf], _cap(path)] for leaf, path in rnd]
                             for rnd in proof.fri.query_rounds],
        },
        "initial_openings": [{name: [[int(v) for v in leaf], _cap(path)]
                              for name, (leaf, path) in per.items()}
                             for per in proof.initial_openings],
        "public_inputs": [int(v) for v in proof.public_inputs],
    }


def verifier_key(stated: dict, fri: dict, circuit_config: dict, common) -> dict:
    """The reference's verifier key: what the configuration states (size,
    gates, public inputs, the circuit's digest, FRI parameters) and the
    circuit's constants/sigmas cap, whose digest the reference checks against
    the stated one."""
    return {
        **stated,
        **fri,
        "num_wires": circuit_config["num_wires"],
        "num_routed_wires": circuit_config["num_routed_wires"],
        "num_challenges": circuit_config["num_challenges"],
        "constants_sigmas_cap": _cap(common.constants_sigmas_cap),
    }


def shape(common, config) -> dict:
    """A circuit's shape as ``harness/roofline.py::batch_calls`` counts it."""
    return {"n": common.n, "num_wires": config.num_wires,
            "num_routed_wires": config.num_routed_wires, "num_challenges": config.num_challenges,
            "rate_bits": config.fri.rate_bits, "cap_height": config.fri.cap_height,
            "final_poly_len": config.fri.final_poly_len,
            "poseidon_gate": "poseidon" in common.gate_ids}
