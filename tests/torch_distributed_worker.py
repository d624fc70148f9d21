"""Worker of the two-process run of the port's proof axis (run as a script).

    python tests/torch_distributed_worker.py <rank> <port> <outdir> <device> <K> <config>

Both processes run the same program: join a two-process gloo group through
``parallel/mesh.py::init_distributed`` with two shards of ``device`` each
(a 2 x 2 mesh), build the zkDSA circuit at ``config`` ("test":
``FriConfig(num_query_rounds=3, proof_of_work_bits=2)``, "standard":
``standard_recursion_config``), prove K witnesses (key 101 + i, message
7 + i) with ``prove_batch(mesh=)``, verify every proof, prove its half of the witnesses
once more without a mesh (K/2 single-process proofs, rank 0 the first
half), and write both to ``<outdir>/proofs.<rank>.pkl`` as
``{"gathered": [...], "single": [...]}``.  ``tests/test_torch_distributed.py``
runs it on the CPU; ``chip_smoke.py`` runs it with both ranks on one card.
"""

import os
import pickle
import sys

import torch

torch.set_num_threads(1)


def main() -> None:
    rank, port, outdir, device, K, config = sys.argv[1:7]
    rank, K = int(rank), int(K)
    import torch.distributed as dist

    from intmax_zkp_core_tpu_torch.engine.batch_prover import prove_batch
    from intmax_zkp_core_tpu_torch.engine.config import CircuitConfig, FriConfig
    from intmax_zkp_core_tpu_torch.engine.witness import PartialWitness
    from intmax_zkp_core_tpu_torch.models.zkdsa.circuits import make_simple_signature_circuit
    from intmax_zkp_core_tpu_torch.parallel.mesh import init_distributed
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
    tmp = os.path.join(outdir, f"proofs.{rank}.pkl.tmp")
    with open(tmp, "wb") as f:
        pickle.dump({"gathered": proofs, "single": single}, f)
    os.replace(tmp, os.path.join(outdir, f"proofs.{rank}.pkl"))
    dist.barrier()
    dist.destroy_process_group()
    print(f"[worker {rank}] OK " + " ".join(f"{k}={v:.3f}" for k, v in timings.items()),
          flush=True)


if __name__ == "__main__":
    main()
