"""Proof (de)serialization — JSON with hex digests, mirroring the
reference's serde-everywhere persistence model (every witness/proof object
is its own checkpoint format, SURVEY §5.4)."""

from __future__ import annotations

from .fri import FriProof
from .prover import Proof


def _cap_json(cap):
    return [[int(x) for x in d] for d in cap]


def proof_to_json(proof: Proof) -> dict:
    return {
        "wires_cap": _cap_json(proof.wires_cap),
        "zs_pp_cap": _cap_json(proof.zs_pp_cap),
        "quotient_cap": _cap_json(proof.quotient_cap),
        "openings": {k: [[int(a), int(b)] for a, b in v] for k, v in proof.openings.items()},
        "fri": {
            "caps": [_cap_json(c) for c in proof.fri.caps],
            "final_poly": [[int(a), int(b)] for a, b in proof.fri.final_poly],
            "pow_witness": int(proof.fri.pow_witness),
            "query_rounds": [
                [[[int(v) for v in leaf], _cap_json(path)] for leaf, path in per_layer]
                for per_layer in proof.fri.query_rounds
            ],
        },
        "initial_openings": [
            {
                name: [[int(v) for v in leaf], _cap_json(path)]
                for name, (leaf, path) in per.items()
            }
            for per in proof.initial_openings
        ],
        "public_inputs": [int(v) for v in proof.public_inputs],
    }


def proof_from_json(o: dict) -> Proof:
    def caps(c):
        return [tuple(d) for d in c]

    return Proof(
        wires_cap=caps(o["wires_cap"]),
        zs_pp_cap=caps(o["zs_pp_cap"]),
        quotient_cap=caps(o["quotient_cap"]),
        openings={k: [tuple(x) for x in v] for k, v in o["openings"].items()},
        fri=FriProof(
            caps=[caps(c) for c in o["fri"]["caps"]],
            final_poly=[tuple(c) for c in o["fri"]["final_poly"]],
            pow_witness=o["fri"]["pow_witness"],
            query_rounds=[
                [(list(leaf), caps(path)) for leaf, path in per_layer]
                for per_layer in o["fri"]["query_rounds"]
            ],
        ),
        initial_openings=[
            {name: (list(leaf), caps(path)) for name, (leaf, path) in per.items()}
            for per in o["initial_openings"]
        ],
        public_inputs=list(o["public_inputs"]),
    )
