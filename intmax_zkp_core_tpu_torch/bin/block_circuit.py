"""Full block production end to end -- the flagship entry point (reference
``src/bin/block_circuit.rs``): proves the user transactions (one with a
deposit merge), the signatures and the block-production circuit, writes the
block's ``BlockInfo`` as JSON (the ``test_cases/block1_info.json`` format),
checks it against the committed vector, and proves a batch of ``n_blocks``
block proofs over it.

Like the reference, the block circuit verifies the inner user-tx and
signature proofs in the circuit (``rollup/circuits/mod.rs:450-489``).

    python -m intmax_zkp_core_tpu_torch.bin.block_circuit [--out PATH] [--cache-dir DIR] [--check-only] [--fast]

``--out`` names the JSON file written (default
``intmax_zkp_core_tpu_torch/_build/block1_info.json``); the committed vector
is only read.  ``--cache-dir`` keeps the flow's three circuits (user-tx,
zkDSA, block) in the circuit cache under DIR: the first run builds and
writes them, a later one loads them (``engine/circuit_cache.py``).  It prints
each circuit's build or load seconds and the sha256 of the block and batch
proofs (of ``json.dumps(proof_to_json(proof), sort_keys=True)``).
``--check-only`` checks every witness instead of proving (no batch proof);
``--fast`` takes the trusted-aggregation mode (inner proofs verified on the
host at witness time: a weaker object, a much smaller circuit).  The flow
runs on the CUDA device and raises without one.
"""

from __future__ import annotations

import hashlib
import json
import pathlib
import sys
import time
from types import SimpleNamespace

ROOT = pathlib.Path(__file__).resolve().parent.parent.parent
DEFAULT_OUT = ROOT / "intmax_zkp_core_tpu_torch" / "_build" / "block1_info.json"
COMMITTED = ROOT / "test_cases" / "block1_info.json"


def prove_batch_over(block_circuit, block_proofs: list, device=None,
                     timings: dict | None = None) -> SimpleNamespace:
    """The batch circuit of ``n_blocks`` recursive block proofs
    (``models/rollup/gadgets/batch.py``), ``block_proofs`` in its first
    slots and the last of them, disabled, in the rest; proved and verified
    on ``device`` (``None``: the CUDA device, raising without one).
    Returns ``data``, ``witness`` and ``proof``.  ``timings``, when given,
    receives seconds per stage (``build_batch_circuit``, ``batch_witness``,
    ``prove_batch``, ``verify_batch``) and, under ``prove_batch_phases``,
    the prove's seconds per phase, all on the device's timeline with no
    synchronize (``engine/spans.py::PhaseTimer``)."""
    from ..engine.circuit import CircuitBuilder
    from ..engine.prover import PhaseTimer
    from ..engine.witness import PartialWitness
    from ..models.rollup.gadgets.batch import BlockBatchTarget
    from ..ops import goldilocks as gl

    device = gl.resolve_device(device)
    stage = PhaseTimer(timings, device, prefix="block_batch")
    phases = None if timings is None else timings.setdefault("prove_batch_phases", {})
    stage.phase("build_batch_circuit")
    builder = CircuitBuilder(block_circuit.data.common.config, device)
    batch = BlockBatchTarget.add_virtual_to(
        builder, block_circuit.data, block_circuit.constants.n_blocks)
    data = builder.build()
    stage.phase("batch_witness")
    pw = PartialWitness()
    batch.set_witness(pw, block_proofs)
    stage.phase("prove_batch")
    proof = data.prove(pw, timings=phases)
    stage.phase("verify_batch")
    data.verify(proof)
    stage.close()
    return SimpleNamespace(data=data, witness=pw, proof=proof)


def proof_sha256(proof) -> str:
    from ..engine.serde import proof_to_json

    return hashlib.sha256(json.dumps(proof_to_json(proof), sort_keys=True).encode()).hexdigest()


def main(out=DEFAULT_OUT, prove: bool = True, recursive: bool = True,
         cache_dir: str | None = None) -> dict:
    """Run the flow; returns ``{"flow": BlockFlowResult, "batch"}`` (the
    ``prove_batch_over`` result, ``None`` without proving)."""
    from ..models.rollup.block import BlockInfo
    from ..models.rollup.block_flow import run_block_flow

    t0 = time.time()
    timings = {}
    res = run_block_flow(prove=prove, recursive=recursive, timings=timings, cache_dir=cache_dir)
    print(f"block flow completed in {time.time() - t0:.1f}s", flush=True)
    circuits = " ".join(f"{k}={timings[k]:.3f}s" for k in
                        ("build_user_tx_circuit", "build_zkdsa_circuit", "build_block_circuit"))
    print(f"circuits ({'cache ' + cache_dir if cache_dir else 'built'}): {circuits}", flush=True)

    encoded = json.dumps(res.block_info.to_json(), indent=1)
    out = pathlib.Path(out)
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(encoded)
    decoded = BlockInfo.from_json(json.loads(encoded))
    assert decoded == res.block_info, "decode != encode"
    committed = json.loads(COMMITTED.read_text())
    assert res.block_info.to_json() == committed, f"{out} differs from {COMMITTED}"
    print(f"wrote {out}; equal to {COMMITTED.name}", flush=True)

    batch = None
    if prove:
        t0 = time.time()
        batch = prove_batch_over(res.block_circuit, [res.block_proof.proof])
        print(f"batch proof ok in {time.time() - t0:.1f}s; rows={batch.data.common.n}",
              flush=True)
        print(f"block proof sha256 {proof_sha256(res.block_proof.proof)}", flush=True)
        print(f"batch proof sha256 {proof_sha256(batch.proof)}", flush=True)
    return {"flow": res, "batch": batch}


if __name__ == "__main__":
    args = sys.argv[1:]
    out = DEFAULT_OUT
    if "--out" in args:
        out = args[args.index("--out") + 1]
    cache_dir = None
    if "--cache-dir" in args:
        cache_dir = args[args.index("--cache-dir") + 1]
    main(
        out=out,
        prove="--check-only" not in args,
        recursive="--fast" not in args,
        cache_dir=cache_dir,
    )
