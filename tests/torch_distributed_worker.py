"""Worker of the two-process runs of the port's mesh (run as a script).

    python tests/torch_distributed_worker.py <rank> <port> <outdir> <device> <K> <config> [<cache_dir>]

Both processes run the same program: join a two-process gloo group through
``parallel/mesh.py::init_distributed`` with two shards of ``device`` each
(a 2 x 2 mesh) and build the zkDSA circuit at ``config`` ("test":
``FriConfig(num_query_rounds=3, proof_of_work_bits=2)``, "standard":
``standard_recursion_config``).  Then:

* the proof axis: prove K witnesses (key 101 + i, message 7 + i) with
  ``prove_batch(mesh=)``, verify every proof, and prove its half of the
  witnesses once more without a mesh (K/2 single-process proofs, rank 0
  the first half);
* the commit mesh across the processes, as a 2 x 1 mesh (one shard each)
  and as the 2 x 2 mesh: a commitment (``engine/prover.py::_commit_batch``
  of seeded coefficients, "test" [9, 2^10], "standard" the block's wires
  [135, 2^16]; rate bits 3, cap height 4; "standard" in both sponge
  wirings, "test" also at cap height 0) held against the unsharded one on
  this process, with this rank's kernel launches and exchange bytes and
  seconds; the distributed
  prove step against one shard's; the K witnesses proved as one batch
  under ``use_commit_mesh(mesh, min_lde=1)``;
* with ``cache_dir``: ``run_block_flow(prove=True, recursive=True)`` on the
  circuits of that circuit cache and ``bin/block_circuit.py``'s batch proof
  over it under a commit mesh over the two processes (2 x 1): the proofs'
  sha256, the block proof's seconds, commit phases and peak device memory;
  then ``run_mini_recursive_block`` over the same mesh.

Everything goes to ``<outdir>/proofs.<rank>.pkl``; any mismatch raises (a
non-zero exit).  ``tests/test_torch_distributed.py`` runs it on the CPU;
``chip_smoke.py`` runs it with both ranks on one card.
"""

import hashlib
import json
import os
import pickle
import sys
import time

import numpy as np
import torch

torch.set_num_threads(1)

P = 0xFFFFFFFF00000001
COMMIT_SHAPES = {"test": (9, 10), "standard": (135, 16)}  # rows, log2 length
RATE_BITS, CAP_HEIGHT = 3, 4
STEP_STATES, STEP_LOG_N = 64, 8  # the distributed prove step's inputs


def commit_coeffs(config):
    """The commitment's coefficients [S, n] as numpy u64 (seed 13)."""
    rows, log_n = COMMIT_SHAPES[config]
    return np.random.default_rng(13).integers(0, P, size=(rows, 1 << log_n), dtype=np.uint64)


def sha256(proof) -> str:
    from intmax_zkp_core_tpu_torch.engine.serde import proof_to_json

    return hashlib.sha256(json.dumps(proof_to_json(proof), sort_keys=True).encode()).hexdigest()


def synchronize(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def check_commit(coeffs, mesh, fused, device, keep: bool, cap_height: int = CAP_HEIGHT) -> dict:
    """``_commit_batch`` under a commit mesh against it without one; with
    ``keep``, the LDE and the levels on the CPU."""
    from intmax_zkp_core_tpu_torch.engine.prover import _commit_batch
    from intmax_zkp_core_tpu_torch.ops import poseidon_cuda as pc
    from intmax_zkp_core_tpu_torch.parallel import mesh as pm

    counts = pc.launch_counts()
    t0 = time.perf_counter()
    want = _commit_batch(coeffs, RATE_BITS, cap_height, True, fused)
    synchronize(device)
    unsharded_seconds = time.perf_counter() - t0
    unsharded = {k: v - counts[k] for k, v in pc.launch_counts().items() if v != counts[k]}
    counts, stats = pc.launch_counts(), dict(pm.EXCHANGE_STATS)
    t0 = time.perf_counter()
    with pm.use_commit_mesh(mesh, min_lde=1):
        got = _commit_batch(coeffs, RATE_BITS, cap_height, True, fused)
    synchronize(device)
    seconds = time.perf_counter() - t0
    launches = {k: v - counts[k] for k, v in pc.launch_counts().items() if v != counts[k]}
    got_levels, want_levels = got[2][0].levels, want[2][0].levels
    bad = int((got[1] != want[1]).sum()) + sum(
        int((a != b).sum()) for a, b in zip(got_levels, want_levels))
    if bad or len(got_levels) != len(want_levels):
        raise RuntimeError(f"the commitment over {mesh.size} shards: {bad} mismatches")
    kept = {"lde": got[1][0].cpu(), "levels": [lv.cpu() for lv in got_levels]} if keep else {}
    return {**kept, "seconds": seconds, "launches": launches, "launches_unsharded": unsharded,
            "unsharded_seconds": unsharded_seconds,
            **{f"exchange_{k}": pm.EXCHANGE_STATS[k] - stats[k] for k in stats}}


def check_prove_step(mesh, device) -> None:
    """The distributed prove step over ``mesh`` against one shard's."""
    from intmax_zkp_core_tpu_torch.ops import goldilocks as gl
    from intmax_zkp_core_tpu_torch.parallel.mesh import Mesh, gather
    from intmax_zkp_core_tpu_torch.parallel.prove_step import make_distributed_prove_step

    rng = np.random.default_rng(17)
    states = gl.from_u64(rng.integers(0, P, size=(STEP_STATES, 12), dtype=np.uint64), device)
    poly = gl.from_u64(rng.integers(0, P, size=(1 << STEP_LOG_N,), dtype=np.uint64), device)
    hashed, evals, root = make_distributed_prove_step(mesh)(states, poly)
    w_hashed, w_evals, w_root = make_distributed_prove_step(Mesh([device]))(states, poly)
    if not (torch.equal(gather(hashed, 0, device, mesh), w_hashed[0])
            and torch.equal(gather(evals, -1, device, mesh), w_evals[0])
            and torch.equal(root, w_root)):
        raise RuntimeError(f"the prove step over {mesh.size} shards differs from one shard's")


def run_flow(cache_dir, mesh, device) -> dict:
    """The block flow from the circuit cache and ``bin/block_circuit.py``'s
    batch proof over its block proof, every commitment of at least the
    commit mesh's threshold over ``mesh``; then the mini recursive block
    with ``mesh`` as its mesh (the proof axis and the commitments)."""
    from intmax_zkp_core_tpu_torch.bin.block_circuit import prove_batch_over
    from intmax_zkp_core_tpu_torch.models.rollup.block_flow import run_block_flow
    from intmax_zkp_core_tpu_torch.models.rollup.mini_block import run_mini_recursive_block
    from intmax_zkp_core_tpu_torch.parallel import merkle_sharded as ms
    from intmax_zkp_core_tpu_torch.parallel import mesh as pm

    timings = {}
    calls, stats = ms.SHARDED_TREE_CALLS, dict(pm.EXCHANGE_STATS)
    torch.cuda.reset_peak_memory_stats(device)
    t0 = time.perf_counter()
    with pm.use_commit_mesh(mesh):
        res = run_block_flow(prove=True, recursive=True, device=device, timings=timings,
                             cache_dir=cache_dir)
        synchronize(device)
        flow_s = time.perf_counter() - t0
        out = {"sha256": sha256(res.block_proof.proof), "flow_s": flow_s,
               "prove_s": timings["prove_block"], "phases": timings["prove_block_phases"],
               "peak": torch.cuda.max_memory_allocated(device),
               "sharded_trees": ms.SHARDED_TREE_CALLS - calls,
               **{f"exchange_{k}": pm.EXCHANGE_STATS[k] - stats[k] for k in stats}}
        calls = ms.SHARDED_TREE_CALLS
        batch = prove_batch_over(res.block_circuit, [res.block_proof.proof], device)
    out["batch"] = {"sha256": sha256(batch.proof), "sharded_trees": ms.SHARDED_TREE_CALLS - calls}
    t0 = time.perf_counter()
    mini = run_mini_recursive_block(mesh=mesh, device=device)
    out["mini"] = {"sha256": [sha256(p) for p in mini["user_tx_proofs"] + mini["signature_proofs"]]
                   + [sha256(mini["block_proof"].proof)], "seconds": time.perf_counter() - t0}
    return out


def main() -> None:
    rank, port, outdir, device, K, config = sys.argv[1:7]
    cache_dir = sys.argv[7] if len(sys.argv) > 7 else None
    rank, K = int(rank), int(K)
    import torch.distributed as dist

    from intmax_zkp_core_tpu_torch.engine.batch_prover import prove_batch
    from intmax_zkp_core_tpu_torch.engine.config import CircuitConfig, FriConfig
    from intmax_zkp_core_tpu_torch.engine.witness import PartialWitness
    from intmax_zkp_core_tpu_torch.models.zkdsa.circuits import make_simple_signature_circuit
    from intmax_zkp_core_tpu_torch.ops import goldilocks as gl
    from intmax_zkp_core_tpu_torch.parallel.mesh import Mesh, exchange_route, init_distributed, \
        use_commit_mesh
    from intmax_zkp_core_tpu_torch.utils.hash_out import HashOut

    mesh = init_distributed(f"localhost:{port}", 2, rank, devices=[device] * 2)
    assert (mesh.size, mesh.process_count, mesh.process_index) == (4, 2, rank), mesh
    assert init_distributed(devices=[device] * 2) == mesh  # a second call joins nothing
    cfg = (CircuitConfig(fri=FriConfig(num_query_rounds=3, proof_of_work_bits=2))
           if config == "test" else CircuitConfig.standard_recursion_config())
    circ = make_simple_signature_circuit(cfg, device)
    pws = []
    for i in range(K):
        pw = PartialWitness()
        circ.targets.set_witness(pw, HashOut.from_u64(101 + i), HashOut.from_u64(7 + i))
        pws.append(pw)
    timings = {}
    proofs = prove_batch(circ.data, pws, mesh=mesh, timings=timings)
    assert len(proofs) == K
    for p in proofs:
        circ.data.verify(p)
    half = (K + 1) // 2
    single = [circ.data.prove(pw) for pw in pws[rank * half : (rank + 1) * half]]
    out = {"gathered": proofs, "single": single, "commit": {}}

    coeffs = gl.from_u64(commit_coeffs(config), device)[None]
    for shards, m in (("2x1", Mesh([device], 2, rank)), ("2x2", mesh)):
        route = exchange_route(m).backend
        for fused in ((False, True) if config == "standard" else (False,)):
            out["commit"][shards, fused] = {
                "route": route, **check_commit(coeffs, m, fused, device, config == "test")}
        if config == "test":  # a cap smaller than the mesh: the block roots cross processes
            check_commit(coeffs, m, False, device, False, cap_height=0)
        check_prove_step(m, device)
        with use_commit_mesh(m, min_lde=1):
            out["commit"][shards, "zkdsa"] = prove_batch(circ.data, pws)
            try:
                prove_batch(circ.data, pws[:1], mesh=m)
            except ValueError:
                pass
            else:
                raise RuntimeError("a proof-axis mesh inside a commit mesh over processes ran")
    if cache_dir is not None:
        out["flow"] = run_flow(cache_dir, Mesh([device], 2, rank), device)

    tmp = os.path.join(outdir, f"proofs.{rank}.pkl.tmp")
    with open(tmp, "wb") as f:
        pickle.dump(out, f)
    os.replace(tmp, os.path.join(outdir, f"proofs.{rank}.pkl"))
    dist.barrier()
    dist.destroy_process_group()
    print(f"[worker {rank}] OK " + " ".join(f"{k}={v:.3f}" for k, v in timings.items()),
          flush=True)


if __name__ == "__main__":
    main()
