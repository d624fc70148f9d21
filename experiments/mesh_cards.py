#!/usr/bin/env python3
"""The mesh over distinct CUDA cards: the part of the multi-device path that
one card cannot run (peer copies, one host thread per card, tables and
launches on every card).

    python3 experiments/mesh_cards.py      # on a host with two or more cards

Builds the kernel library, then, over ``make_mesh()`` (every card):

* the block commitment's shape, wires [135, 2^16] -> LDE 2^19 and its Merkle
  levels at cap height 4, in both wirings: ``coset_lde_sharded`` and
  ``build_merkle_levels_sharded`` against ``coset_lde`` and
  ``build_merkle_levels_batch`` on the first card (0 mismatches; the NTT
  kernel launched 2d times per sharded LDE); the seconds of each, the median
  of ``REPS`` runs (printed, nothing claimed);
* ``MESH_K`` zkDSA proofs (``standard_recursion_config``) with the proof axis
  over the cards (``prove_batch(mesh=)``) and through ``prove_many`` with no
  mesh (the default, every card), against one-card proofs;
* a zkDSA proof whose commitments run over the cards (``use_commit_mesh`` at
  threshold 1), against the one-card proof;
* one process per card, as PyTorch deploys several cards, over 2 cards and
  over all of them (``[cards-processes]``): each process sees only its card
  (``CUDA_VISIBLE_DEVICES``) and joins ``init_distributed``; the commit mesh
  across the processes takes the NCCL route (``parallel/mesh.py::
  exchange_route``).  Each process holds the block's wire commitment over
  the mesh against its own unsharded one in both wirings (seconds the median
  of ``REPS`` runs, and its exchange bytes and seconds), then proves
  ``run_block_flow(prove=True, recursive=True)`` with the block proof's
  commitments over the mesh; every rank's block proof must equal
  ``golden/block_flow_standard.sha256``.

Every mismatch, and a host with fewer than two cards, exits non-zero.  The
last line is ``{"ok": true, "cards": d}``.
"""

from __future__ import annotations

import hashlib
import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from intmax_zkp_core_tpu_torch.engine.batch_prover import prove_batch  # noqa: E402
from intmax_zkp_core_tpu_torch.engine.config import CircuitConfig  # noqa: E402
from intmax_zkp_core_tpu_torch.engine.witness import PartialWitness  # noqa: E402
from intmax_zkp_core_tpu_torch.models.zkdsa import make_simple_signature_circuit  # noqa: E402
from intmax_zkp_core_tpu_torch.ops import cuda_build as cb  # noqa: E402
from intmax_zkp_core_tpu_torch.ops import goldilocks as gl  # noqa: E402
from intmax_zkp_core_tpu_torch.ops import merkle as mk  # noqa: E402
from intmax_zkp_core_tpu_torch.ops import ntt as nt  # noqa: E402
from intmax_zkp_core_tpu_torch.ops import poseidon_cuda as pc  # noqa: E402
from intmax_zkp_core_tpu_torch.parallel import merkle_sharded as ms  # noqa: E402
from intmax_zkp_core_tpu_torch.parallel import prove_many  # noqa: E402
from intmax_zkp_core_tpu_torch.parallel import mesh as pm  # noqa: E402
from intmax_zkp_core_tpu_torch.parallel.mesh import gather, make_mesh, use_commit_mesh  # noqa: E402
from intmax_zkp_core_tpu_torch.parallel.ntt_sharded import coset_lde_sharded  # noqa: E402
from intmax_zkp_core_tpu_torch.utils.hash_out import HashOut  # noqa: E402

ROWS, LOG_N, RATE_BITS, CAP_HEIGHT = 135, 16, 3, 4  # the block's wire commitment
MESH_K, REPS = 5, 5
WORKER_TIMEOUT_S = 240  # a process per card: build, commitments, the block flow
GOLDEN = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                      "intmax_zkp_core_tpu_torch", "golden", "block_flow_standard.sha256")


def log(phase: str, **fields) -> None:
    print(f"[{phase}] " + " ".join(f"{k}={v}" for k, v in fields.items()), flush=True)


def sync_all() -> None:
    for i in range(torch.cuda.device_count()):
        torch.cuda.synchronize(i)


def timed(fn):
    """(result of the last run, median seconds over ``REPS`` runs)."""
    seconds = []
    for _ in range(REPS):
        sync_all()
        t0 = time.perf_counter()
        out = fn()
        sync_all()
        seconds.append(time.perf_counter() - t0)
    return out, statistics.median(seconds)


def mismatches(a: torch.Tensor, b: torch.Tensor) -> int:
    return int((a != b).sum().item())


def check_commit(mesh, first) -> None:
    rng = np.random.default_rng(12)
    coeffs = gl.from_u64(rng.integers(0, gl.P_INT, size=(ROWS, 1 << LOG_N), dtype=np.uint64), first)
    before = pc.launch_counts()["ntt_cuda"]
    parts = coset_lde_sharded(coeffs, RATE_BITS, mesh)
    launches = pc.launch_counts()["ntt_cuda"] - before
    lde, lde_s = timed(lambda: nt.coset_lde(coeffs, RATE_BITS))
    parts, sharded_lde_s = timed(lambda: coset_lde_sharded(coeffs, RATE_BITS, mesh))
    bad = mismatches(gather(parts, -1, first), lde)
    if bad or launches != 2 * mesh.size:
        raise RuntimeError(f"sharded LDE over {mesh.devices}: {bad} mismatches, {launches} "
                           f"NTT launches against {2 * mesh.size}")
    for fused in (False, True):
        want, tree_s = timed(lambda: mk.build_merkle_levels_batch(lde.t()[None], CAP_HEIGHT,
                                                                  fused_sponge=fused))
        levels, sharded_tree_s = timed(lambda: ms.build_merkle_levels_sharded(
            [p.t() for p in parts], CAP_HEIGHT, mesh, fused_sponge=fused))
        bad = sum(mismatches(gather(lv, -2, first), w[0]) for lv, w in zip(levels, want))
        if bad or len(levels) != len(want):
            raise RuntimeError(f"sharded tree over {mesh.devices}: {bad} mismatches")
        log("cards-commit", cards=mesh.size, lde=f"1 << {LOG_N + RATE_BITS} of {ROWS} rows",
            wiring="fused" if fused else "chained", lde_mismatches=0, tree_mismatches=0,
            ntt_launches=launches, lde_s=lde_s, sharded_lde_s=sharded_lde_s, tree_s=tree_s,
            sharded_tree_s=sharded_tree_s)


def zkdsa_witness(circuit, i):
    pw = PartialWitness()
    circuit.targets.set_witness(pw, HashOut.from_u64(101 + i), HashOut.from_u64(7 + i))
    return pw


def check_proofs(mesh) -> None:
    circuit = make_simple_signature_circuit(CircuitConfig.standard_recursion_config())
    pws = [zkdsa_witness(circuit, i) for i in range(MESH_K)]
    single = [circuit.data.prove(pw) for pw in pws]
    timings = {}
    got = prove_batch(circuit.data, pws, mesh=mesh, timings=timings)
    if got != single:
        raise RuntimeError(f"zkDSA proofs over {mesh.devices} differ from one card's")
    fns = [lambda pw, i=i: circuit.targets.set_witness(pw, HashOut.from_u64(101 + i),
                                                       HashOut.from_u64(7 + i))
           for i in range(MESH_K)]
    if prove_many(circuit, fns) != single:
        raise RuntimeError("prove_many over the default mesh differs from one card's proofs")
    calls = ms.SHARDED_TREE_CALLS
    with use_commit_mesh(mesh, min_lde=1):
        proof = circuit.data.prove(pws[0])
    if proof != single[0] or ms.SHARDED_TREE_CALLS != calls + 3:
        raise RuntimeError(f"a zkDSA proof committed over {mesh.devices} differs from one card's")
    log("cards-proofs", cards=mesh.size, K=MESH_K, lanes=-(-MESH_K // mesh.size) * mesh.size,
        proof_axis="equal to one card's", default_mesh="equal to one card's",
        commit_mesh="equal to one card's", **{f"{k}_s": v for k, v in timings.items()})


def card_process(rank: int, world: int, port: int) -> None:
    """One process of ``[cards-processes]`` (its card is its ``cuda:0``):
    prints one JSON line of its results."""
    from intmax_zkp_core_tpu_torch.engine.prover import _commit_batch
    from intmax_zkp_core_tpu_torch.engine.serde import proof_to_json
    from intmax_zkp_core_tpu_torch.models.rollup.block_flow import run_block_flow

    mesh = pm.init_distributed(f"localhost:{port}", world, rank, devices=["cuda:0"])
    route = pm.exchange_route(mesh).backend
    if route != "nccl":
        raise RuntimeError(f"one process per card took the {route} route, not NCCL")
    card = torch.device("cuda:0")
    rng = np.random.default_rng(12)
    coeffs = gl.from_u64(rng.integers(0, gl.P_INT, size=(ROWS, 1 << LOG_N), dtype=np.uint64),
                         card)[None]
    out = {"rank": rank, "card": str(torch.cuda.get_device_properties(card).uuid)[:8],
           "route": route}
    for fused in (False, True):
        want, seconds = timed(lambda: _commit_batch(coeffs, RATE_BITS, CAP_HEIGHT, True, fused))
        stats = dict(pm.EXCHANGE_STATS)
        with use_commit_mesh(mesh, min_lde=1):
            got, sharded_s = timed(lambda: _commit_batch(coeffs, RATE_BITS, CAP_HEIGHT, True,
                                                         fused))
        bad = mismatches(got[1], want[1]) + sum(
            mismatches(a, b) for a, b in zip(got[2][0].levels, want[2][0].levels))
        if bad:
            raise RuntimeError(f"rank {rank}: the commitment over {world} cards, {bad} mismatches")
        out["chained" if not fused else "fused"] = {
            "seconds": seconds, "sharded_seconds": sharded_s,
            **{f"exchange_{k}_per_run": (pm.EXCHANGE_STATS[k] - stats[k]) / REPS
               for k in stats}}
    timings = {}
    stats = dict(pm.EXCHANGE_STATS)
    with use_commit_mesh(mesh):
        res = run_block_flow(prove=True, recursive=True, timings=timings)
    out["block"] = {
        "sha256": hashlib.sha256(json.dumps(
            proof_to_json(res.block_proof.proof), sort_keys=True).encode()).hexdigest(),
        "prove_s": timings["prove_block"],
        "commit_phases_s": {k: timings["prove_block_phases"][k]
                            for k in ("commit_wires", "perm_columns", "quotient_commit")},
        **{f"exchange_{k}": pm.EXCHANGE_STATS[k] - stats[k] for k in stats}}
    torch.distributed.barrier()
    torch.distributed.destroy_process_group()
    print(json.dumps(out), flush=True)


def check_processes(world: int) -> None:
    """``world`` processes, one per card, each running ``card_process``."""
    import socket

    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    t0 = time.perf_counter()
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--rank", str(rank), "--world", str(world),
         "--port", str(port)],
        env={**os.environ, "CUDA_VISIBLE_DEVICES": str(rank)},
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True) for rank in range(world)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=WORKER_TIMEOUT_S)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for rank, (p, text) in enumerate(zip(procs, outs)):
        if p.returncode != 0:
            raise RuntimeError(f"card process {rank} of {world} exited {p.returncode}:\n"
                               f"{text[-4000:]}")
    with open(GOLDEN) as f:
        golden = [ln.split()[0] for ln in f.read().splitlines()
                  if ln and not ln.startswith(("#", "circuit_digest"))][0]
    for text in outs:
        r = json.loads(text.strip().splitlines()[-1])
        if r["block"]["sha256"] != golden:
            raise RuntimeError(f"rank {r['rank']} of {world}: block proof {r['block']['sha256']} "
                               f"!= golden {golden}")
        log("cards-processes", processes=world, block_proof="equal to the golden",
            seconds=round(time.perf_counter() - t0, 3), **r)


def main() -> int:
    if "--rank" in sys.argv:
        args = dict(zip(sys.argv[1::2], sys.argv[2::2]))
        card_process(int(args["--rank"]), int(args["--world"]), int(args["--port"]))
        return 0
    if not torch.cuda.is_available() or torch.cuda.device_count() < 2:
        print("this script needs two or more CUDA cards", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    for line in smi.splitlines():
        print(line, flush=True)
    log("build", seconds=round(cb.build(), 3))
    mesh = make_mesh()
    first = mesh.devices[0]
    log("cards", devices=[str(d) for d in mesh.devices],
        peer_access=[torch.cuda.can_device_access_peer(0, i) for i in range(1, mesh.size)])
    check_commit(mesh, first)
    check_proofs(mesh)
    for world in sorted({2, mesh.size}):
        check_processes(world)
    print(json.dumps({"ok": True, "cards": mesh.size}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
