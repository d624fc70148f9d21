#!/usr/bin/env python3
"""Make the port's block-flow goldens from the JAX package, on the CPU.

    JAX_PLATFORMS=cpu python experiments/make_block_goldens.py [block|mini|gadgets|recursion|records ...] [--dump DIR]

``block``: the JAX package's ``models/rollup/block_flow.py::run_block_flow``
with ``prove=True, recursive=True`` at ``RollupConstants.test_constants()``
and ``CircuitConfig.standard_recursion_config()`` (the recursive block
circuit, the inner proofs verified in the circuit), then the batch proof of
``bin/block_circuit.py`` (``BlockBatchTarget`` over ``n_blocks`` = 2 slots,
the block proof in the first, the second disabled) ->
``golden/block_flow_standard.sha256``: the block circuit's digest and rows,
the block proof's hash, the batch circuit's digest and rows, the batch
proof's hash.  The JAX binary itself is not run: it rewrites
``test_cases/block1_info.json``.

``mini``: ``models/rollup/mini_block.py::run_mini_recursive_block`` at
``MINI`` / ``MINI_CFG`` -> ``golden/mini_block_test.sha256``: the three
circuits' digests and the block proof's hash.

``gadgets``: the four rollup gadgets of ``tests/rollup_gadget_circuits.py``,
each alone in a circuit at ``MINI`` / ``MINI_CFG``, built by the JAX
package -> ``golden/rollup_gadgets_mini.sha256``: each circuit's digest and
rows.

``recursion``: the circuit of ``tests/test_recursion.py`` (an outer circuit
verifying a zkDSA proof in the circuit, ``CircuitConfig(fri=FriConfig(3,
2))``) built by the JAX package -> ``golden/recursion_zkdsa.sha256``: the
outer circuit's digest and rows; and a zkDSA proof of that config made by
the JAX package (key 11, message 222) -> ``golden/recursion_zkdsa_inner.json``
(``proof_to_json``), the inner proof the port's test carries across.

``records``: the JAX package's recursive block circuit at
``test_constants`` / ``standard_recursion_config`` on its own user-tx and
zkDSA builds, taken at its ``build()``, which is not run ->
``golden/block_records_standard.sha256``: ``records_sha256`` of
``tests/rollup_gadget_circuits.py`` over the builder's records.

A proof's hash is the sha256 of ``json.dumps(proof_to_json(proof),
sort_keys=True)``, the form the port's tests and ``chip_smoke.py`` hash.
``--dump DIR`` also writes every proof as JSON under DIR.  ``block`` takes
the better part of an hour on a few CPU cores; ``mini`` some minutes.
"""

from __future__ import annotations

import hashlib
import json
import pathlib
import sys
import time

from intmax_zkp_core_tpu.config import RollupConstants
from intmax_zkp_core_tpu.engine.config import CircuitConfig
from intmax_zkp_core_tpu.engine.serde import proof_to_json

GOLDEN = pathlib.Path(__file__).resolve().parent.parent / "intmax_zkp_core_tpu_torch" / "golden"


def proof_sha256(proof) -> str:
    return hashlib.sha256(json.dumps(proof_to_json(proof), sort_keys=True).encode()).hexdigest()


def digest_line(data, what: str) -> str:
    limbs = " ".join(str(int(x)) for x in data.common.circuit_digest)
    return (f"circuit_digest {limbs}  (common.circuit_digest of the JAX package's build of "
            f"{what}; {data.common.n} rows)")


def dump(dump_dir, name: str, proof) -> None:
    if dump_dir is not None:
        dump_dir.mkdir(parents=True, exist_ok=True)
        (dump_dir / f"{name}.json").write_text(json.dumps(proof_to_json(proof)))


def make_block(dump_dir) -> None:
    from intmax_zkp_core_tpu.engine.circuit import CircuitBuilder
    from intmax_zkp_core_tpu.engine.witness import PartialWitness
    from intmax_zkp_core_tpu.models.rollup.block_flow import run_block_flow
    from intmax_zkp_core_tpu.models.rollup.gadgets.batch import BlockBatchTarget

    t0 = time.perf_counter()
    res = run_block_flow(RollupConstants.test_constants(),
                         CircuitConfig.standard_recursion_config(), prove=True, recursive=True)
    print(f"block flow: {time.perf_counter() - t0:.1f} s", flush=True)
    block = res.block_circuit
    proof = res.block_proof.proof
    dump(dump_dir, "block_proof", proof)
    for i, p in enumerate(res.user_tx_proofs):
        dump(dump_dir, f"user_tx_{i}", p)
    dump(dump_dir, "signature_1", res.block_detail.received_signature_proofs[1])
    lines = [
        "# block_flow_standard: the JAX package's models/rollup/block_flow.py::run_block_flow("
        "prove=True, recursive=True) at RollupConstants.test_constants() and "
        "CircuitConfig.standard_recursion_config(), then the batch proof of "
        "bin/block_circuit.py (BlockBatchTarget over n_blocks slots, the block proof in the "
        "first, the rest disabled); made by experiments/make_block_goldens.py block; a proof's "
        "line is the sha256 of json.dumps(proof_to_json(proof), sort_keys=True)",
        digest_line(block.data, "the recursive block circuit"),
        f"{proof_sha256(proof)}  block proof",
    ]
    (GOLDEN / "block_flow_standard.sha256").write_text("\n".join(lines) + "\n")

    t0 = time.perf_counter()
    builder = CircuitBuilder(block.data.common.config)
    batch = BlockBatchTarget.add_virtual_to(builder, block.data, block.constants.n_blocks)
    batch_data = builder.build()
    pw = PartialWitness()
    batch.set_witness(pw, [proof])
    batch_proof = batch_data.prove(pw)
    batch_data.verify(batch_proof)
    print(f"batch: {time.perf_counter() - t0:.1f} s", flush=True)
    dump(dump_dir, "batch_proof", batch_proof)
    lines += [digest_line(batch_data, f"the batch circuit over {block.constants.n_blocks} "
                                      "block proofs"),
              f"{proof_sha256(batch_proof)}  batch proof"]
    (GOLDEN / "block_flow_standard.sha256").write_text("\n".join(lines) + "\n")


def make_mini(dump_dir) -> None:
    from intmax_zkp_core_tpu.models.rollup.mini_block import run_mini_recursive_block

    r = run_mini_recursive_block()
    user, sig = r["user_tx_proofs"], r["signature_proofs"]
    block = r["block_circuit"]
    proof = r["block_proof"].proof
    dump(dump_dir, "mini_block_proof", proof)
    for i, p in enumerate(user + sig):
        dump(dump_dir, f"mini_inner_{i}", p)
    lines = [
        "# mini_block_test: the JAX package's models/rollup/mini_block.py::"
        "run_mini_recursive_block() at MINI / MINI_CFG; made by "
        "experiments/make_block_goldens.py mini; a proof's line is the sha256 of "
        "json.dumps(proof_to_json(proof), sort_keys=True)",
        digest_line(block.data, "the mini recursive block circuit"),
        f"{proof_sha256(user[0])}  user_tx_proofs[0]",
        f"{proof_sha256(user[1])}  user_tx_proofs[1] default",
        f"{proof_sha256(sig[0])}  signature_proofs[0]",
        f"{proof_sha256(sig[1])}  signature_proofs[1] default",
        f"{proof_sha256(proof)}  block proof",
    ]
    (GOLDEN / "mini_block_test.sha256").write_text("\n".join(lines) + "\n")


def make_gadgets(dump_dir) -> None:
    sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent / "tests"))
    import rollup_gadget_circuits as rg

    lines = ["# rollup_gadgets_mini: the block circuit's rollup gadgets, each alone in a circuit "
             "at MINI / MINI_CFG (tests/rollup_gadget_circuits.py), built by the JAX package; "
             "made by experiments/make_block_goldens.py gadgets"]
    for name in rg.GADGETS:
        data, _ = rg.make("intmax_zkp_core_tpu", name)
        lines.append(f"{name} " + digest_line(data, f"the {name} gadget's circuit"))
    (GOLDEN / "rollup_gadgets_mini.sha256").write_text("\n".join(lines) + "\n")


def make_recursion(dump_dir) -> None:
    from intmax_zkp_core_tpu.engine.circuit import CircuitBuilder
    from intmax_zkp_core_tpu.engine.config import FriConfig
    from intmax_zkp_core_tpu.models.recursion.gadgets import RecursiveProofTarget
    from intmax_zkp_core_tpu.models.zkdsa import make_simple_signature_circuit
    from intmax_zkp_core_tpu.utils.hash_out import HashOut

    cfg = CircuitConfig(fri=FriConfig(num_query_rounds=3, proof_of_work_bits=2))
    inner = make_simple_signature_circuit(cfg)
    proof = inner.prove(HashOut.from_u32(11), HashOut.from_u32(222))
    inner.verify(proof)
    (GOLDEN / "recursion_zkdsa_inner.json").write_text(json.dumps(proof_to_json(proof)) + "\n")
    builder = CircuitBuilder(cfg)
    target = RecursiveProofTarget.add_virtual_to(builder, inner.data, in_circuit=True)
    builder.register_public_inputs(list(target.public_inputs))
    outer = builder.build()
    lines = [
        "# recursion_zkdsa: tests/test_recursion.py's outer circuit (RecursiveProofTarget over "
        "the zkDSA circuit, in_circuit=True, its public inputs registered) at "
        "CircuitConfig(fri=FriConfig(num_query_rounds=3, proof_of_work_bits=2)), built by the "
        "JAX package; made by experiments/make_block_goldens.py recursion",
        digest_line(outer, "the outer circuit"),
        f"{proof_sha256(proof)}  recursion_zkdsa_inner.json (the JAX package's zkDSA proof, "
        "key 11, message 222)",
    ]
    (GOLDEN / "recursion_zkdsa.sha256").write_text("\n".join(lines) + "\n")


def make_records(dump_dir) -> None:
    sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent / "tests"))
    import rollup_gadget_circuits as rg
    from intmax_zkp_core_tpu.engine.circuit import CircuitBuilder
    from intmax_zkp_core_tpu.models.rollup.circuits import make_block_proof_circuit
    from intmax_zkp_core_tpu.models.transaction.circuits import make_user_proof_circuit
    from intmax_zkp_core_tpu.models.zkdsa.circuits import make_simple_signature_circuit

    constants, config = RollupConstants.test_constants(), CircuitConfig.standard_recursion_config()
    inner = (make_user_proof_circuit(constants, config), make_simple_signature_circuit(config))
    held = {}
    build = CircuitBuilder.build
    CircuitBuilder.build = lambda self: held.setdefault("builder", self)
    try:
        make_block_proof_circuit(constants, *inner, config, recursive=True)
    finally:
        CircuitBuilder.build = build
    builder = held["builder"]
    (GOLDEN / "block_records_standard.sha256").write_text(
        f"{rg.records_sha256(builder)}  block_records_standard (records_sha256 of "
        "tests/rollup_gadget_circuits.py over the JAX package's recursive block circuit builder at "
        "RollupConstants.test_constants() and CircuitConfig.standard_recursion_config(), taken at "
        f"build(); {len(builder.rows)} gate rows, {len(builder.generators)} generator records; "
        "made by experiments/make_block_goldens.py records)\n")


def main() -> int:
    args = sys.argv[1:]
    dump_dir = None
    if "--dump" in args:
        i = args.index("--dump")
        dump_dir = pathlib.Path(args[i + 1])
        del args[i:i + 2]
    for name in args or ["mini", "block"]:
        t0 = time.perf_counter()
        {"block": make_block, "mini": make_mini, "gadgets": make_gadgets,
         "recursion": make_recursion, "records": make_records}[name](dump_dir)
        print(f"{name}: {time.perf_counter() - t0:.1f} s", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
