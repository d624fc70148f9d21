#!/usr/bin/env python3
"""Make the port's user-transaction goldens from the JAX package, on the CPU.

    JAX_PLATFORMS=cpu python experiments/make_user_tx_goldens.py [small|flow ...]

``small``: the purge-only transition of ``tests/test_user_transaction.py``
(its ``small_constants()``, ``CircuitConfig(fri=FriConfig(4, 2))``) and the
default transaction (sender ``Address(0)``, no merges, no purges, nonce and
old root zero), each proved by the JAX package ->
``golden/user_tx_small_test.sha256``: the purge proof's hash, the circuit's
digest, the default proof's hash.

``flow``: the stages of the JAX package's
``models/rollup/block_flow.py::run_block_flow`` from ``build_user_tx_circuit``
through ``prove_signatures`` at ``RollupConstants.test_constants()`` and
``CircuitConfig.standard_recursion_config()``, each witness proved by a
sequential ``prove`` (the flow's own rule on a CPU backend); the flow is
stopped where it would build the block circuit ->
``golden/user_tx_flow_standard.sha256``: the user-tx circuit's digest and
the five proof hashes (three user transactions, two signatures).

A proof's hash is the sha256 of ``json.dumps(proof_to_json(proof),
sort_keys=True)``, the form the port's tests and ``chip_smoke.py`` hash.
Takes some minutes on a CPU (``flow``: three 4,096-row proofs).
"""

from __future__ import annotations

import hashlib
import json
import pathlib
import sys
import time

from intmax_zkp_core_tpu.config import RollupConstants
from intmax_zkp_core_tpu.engine.config import CircuitConfig, FriConfig
from intmax_zkp_core_tpu.engine.serde import proof_to_json

GOLDEN = pathlib.Path(__file__).resolve().parent.parent / "intmax_zkp_core_tpu_torch" / "golden"


def proof_sha256(proof) -> str:
    return hashlib.sha256(json.dumps(proof_to_json(proof), sort_keys=True).encode()).hexdigest()


def digest_line(data, what: str) -> str:
    limbs = " ".join(str(int(x)) for x in data.common.circuit_digest)
    return f"circuit_digest {limbs}  (common.circuit_digest of the JAX package's build of {what})"


def small_constants() -> RollupConstants:
    """``tests/test_user_transaction.py::small_constants``."""
    return RollupConstants(
        log_max_n_users=3, log_max_n_txs=3, log_max_n_contracts=3, log_max_n_variables=3,
        log_n_txs=2, log_n_recipients=3, log_n_contracts=3, log_n_variables=3,
        n_registrations=1, n_diffs=1, n_merges=1, n_deposits=1, n_scroll_flags=1,
        n_polygon_flags=1, n_blocks=2,
    )


def purge_only_transition():
    """The transition of ``test_user_transaction_purge_only``."""
    from intmax_zkp_core_tpu.models.sparse_merkle_tree import LayeredLayeredSparseMerkleTree
    from intmax_zkp_core_tpu.models.transaction.circuits import MergeAndPurgeTransition
    from intmax_zkp_core_tpu.models.transaction.user_asset_tree import UserAssetTree
    from intmax_zkp_core_tpu.models.zkdsa.account import Address
    from intmax_zkp_core_tpu.utils.hash_out import HashOut

    merge_key, contract, variable = HashOut.from_u32(1), HashOut.from_u32(3), HashOut.from_u32(5)
    amount, recipient = HashOut.from_u32(10), HashOut.from_u32(2)
    user_tree = UserAssetTree()
    user_tree.set(merge_key, contract, variable, amount)
    old_root = user_tree.get_root()
    purge_input = [user_tree.set(merge_key, contract, variable, HashOut.ZERO)]
    diff_tree = LayeredLayeredSparseMerkleTree()
    purge_output = [diff_tree.set(recipient, contract, variable, amount)]
    return MergeAndPurgeTransition(
        sender_address=Address(777), merge_witnesses=[], purge_input_witnesses=purge_input,
        purge_output_witnesses=purge_output, nonce=HashOut.from_u32(99),
        old_user_asset_root=old_root,
    )


def make_small() -> None:
    from intmax_zkp_core_tpu.engine.witness import PartialWitness
    from intmax_zkp_core_tpu.models.transaction.circuits import make_user_proof_circuit
    from intmax_zkp_core_tpu.models.zkdsa.account import Address
    from intmax_zkp_core_tpu.utils.hash_out import HashOut

    circuit = make_user_proof_circuit(
        small_constants(), CircuitConfig(fri=FriConfig(num_query_rounds=4, proof_of_work_bits=2)))
    proof = circuit.prove_transition(purge_only_transition())
    circuit.verify(proof)
    pw = PartialWitness()
    circuit.targets.set_witness(pw, Address(0), [], [], [], HashOut.ZERO, HashOut.ZERO)
    default = circuit.data.prove(pw)
    circuit.verify(default)
    recipe = (
        "user_tx_small_test (the JAX package's make_user_proof_circuit at "
        "tests/test_user_transaction.py::small_constants() and "
        "CircuitConfig(fri=FriConfig(num_query_rounds=4, proof_of_work_bits=2)), proving the "
        "purge-only transition of test_user_transaction_purge_only; made by "
        "experiments/make_user_tx_goldens.py small; sha256 of "
        "json.dumps(proof_to_json(proof), sort_keys=True))")
    default_line = (
        f"{proof_sha256(default)}  default transaction (the same circuit; "
        "set_witness(pw, Address(0), [], [], [], HashOut.ZERO, HashOut.ZERO), proved by prove)")
    (GOLDEN / "user_tx_small_test.sha256").write_text(
        f"{proof_sha256(proof)}  {recipe}\n{digest_line(circuit.data, 'the same circuit')}\n"
        f"{default_line}\n")


class _Stop(Exception):
    pass


def make_flow() -> None:
    from intmax_zkp_core_tpu.models.rollup import block_flow as bf

    groups = []
    prove_group = bf._prove_group

    def recording(circuit, pws, prove):
        proofs = prove_group(circuit, pws, prove)
        groups.append((circuit, proofs))
        return proofs

    def stop(*args, **kwargs):
        raise _Stop

    bf._prove_group = recording
    bf.make_block_proof_circuit = stop
    try:
        bf.run_block_flow(RollupConstants.test_constants(),
                          CircuitConfig.standard_recursion_config(), prove=True, recursive=True)
    except _Stop:
        pass
    (user_tx, user_tx_proofs), (zkdsa, signature_proofs) = groups
    for circuit, proofs in groups:
        for proof in proofs:
            circuit.data.verify(proof)
    labels = ("prove_user_txs[0] sender 1 (transfer only)",
              "prove_user_txs[1] sender 2 (merges the previous block's deposit)",
              "prove_user_txs[2] default transaction",
              "prove_signatures[0] sender 2's signature of the proposed world state root",
              "prove_signatures[1] default signature")
    lines = [
        "# user_tx_flow_standard: the JAX package's models/rollup/block_flow.py::run_block_flow "
        "stages build_user_tx_circuit .. prove_signatures at RollupConstants.test_constants() and "
        "CircuitConfig.standard_recursion_config(), every witness proved by a sequential prove; "
        "made by experiments/make_user_tx_goldens.py flow; a proof's line is the sha256 of "
        "json.dumps(proof_to_json(proof), sort_keys=True)",
        digest_line(user_tx.data, "the user-transaction circuit"),
    ]
    lines += [f"{proof_sha256(p)}  {label}"
              for p, label in zip(user_tx_proofs + signature_proofs, labels)]
    (GOLDEN / "user_tx_flow_standard.sha256").write_text("\n".join(lines) + "\n")


def main() -> int:
    which = sys.argv[1:] or ["small", "flow"]
    for name in which:
        t0 = time.perf_counter()
        {"small": make_small, "flow": make_flow}[name]()
        print(f"{name}: {time.perf_counter() - t0:.1f} s", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
