"""State carried across: build this package's ``CircuitData`` from a circuit
that was built elsewhere and is handed over as plain data.

``state`` is a dict of numpy arrays, ints, lists, tuples and dicts — no
framework types — so a circuit built by the JAX package (or loaded from
disk) can be proved here, and both provers can be held against each other on
exactly the same circuit.  Keys:

* ``config``: ``{"num_wires", "num_routed_wires", "num_challenges",
  "max_degree", "fri": {"rate_bits", "cap_height", "num_query_rounds",
  "proof_of_work_bits", "final_poly_len"}}``
* ``common``: ``{"n", "gate_ids", "n_sel", "n_const_cols", "k_is",
  "num_public_inputs", "circuit_digest", "constants_sigmas_cap"}``
* ``rows`` (list of ``(gate_id, constants)``), ``targets_at_place`` (dict
  ``(row, col) -> target``), ``parent`` (union-find list),
  ``preset_values`` (dict), ``public_input_targets`` (list)
* ``generators``: list of records ``(kind, *params)`` with int / tuple
  params; each kind must be registered in ``engine/generators.py``
* numpy uint64 arrays ``constants_sigmas``, ``cs_coeffs``, ``cs_lde``,
  ``sigma``, ``w_pows`` and ``cs_tree_levels`` (list of ``[m_i, 4]``)
* ``cap_height`` of the constants/sigmas tree.
"""

from __future__ import annotations

import numpy as np

from ..ops import goldilocks as gl
from ..ops import merkle as mk
from .circuit import CircuitData, CommonCircuitData, ProverCircuitData
from .config import CircuitConfig, FriConfig
from .generators import GENERATOR_KINDS


def _plain(x):
    """Nested tuples/lists of Python ints (numpy scalars converted)."""
    if isinstance(x, (tuple, list)):
        return tuple(_plain(v) for v in x)
    return int(x)


def _u64(a) -> np.ndarray:
    return np.ascontiguousarray(np.asarray(a, dtype=np.uint64))


def circuit_from_reference(state: dict, device=None) -> CircuitData:
    device = gl.resolve_device(device)
    c = dict(state["config"])
    config = CircuitConfig(fri=FriConfig(**c.pop("fri")), **c)
    cm = state["common"]
    cap = [tuple(int(x) for x in d) for d in cm["constants_sigmas_cap"]]
    common = CommonCircuitData(
        config=config,
        n=int(cm["n"]),
        gate_ids=[str(g) for g in cm["gate_ids"]],
        n_sel=int(cm["n_sel"]),
        n_const_cols=int(cm["n_const_cols"]),
        k_is=[int(k) for k in cm["k_is"]],
        num_public_inputs=int(cm["num_public_inputs"]),
        circuit_digest=tuple(int(x) for x in cm["circuit_digest"]),
        constants_sigmas_cap=cap,
    )
    generators = []
    for rec in state["generators"]:
        kind = str(rec[0])
        if kind not in GENERATOR_KINDS:
            raise ValueError(f"generator kind {kind!r} is not registered in this package")
        generators.append((kind,) + tuple(_plain(p) for p in rec[1:]))
    cs_tree = mk.MerkleTree(
        levels=[_u64(lv) for lv in state["cs_tree_levels"]],
        cap_height=int(state["cap_height"]),
    )
    if [tuple(int(x) for x in d) for d in cs_tree.cap] != cap:
        raise ValueError("carried constants/sigmas tree does not match the carried cap")
    prover = ProverCircuitData(
        common=common,
        rows=[(str(g), [int(v) for v in consts]) for g, consts in state["rows"]],
        targets_at_place={
            (int(r), int(col)): int(t) for (r, col), t in state["targets_at_place"].items()
        },
        parent=[int(p) for p in state["parent"]],
        generators=generators,
        preset_values={int(t): int(v) for t, v in state["preset_values"].items()},
        public_input_targets=[int(t) for t in state["public_input_targets"]],
        constants_sigmas=_u64(state["constants_sigmas"]),
        cs_coeffs=_u64(state["cs_coeffs"]),
        cs_lde=_u64(state["cs_lde"]),
        cs_tree=cs_tree,
        sigma=_u64(state["sigma"]),
        w_pows=_u64(state["w_pows"]),
    )
    return CircuitData(common=common, prover=prover, device=device)
