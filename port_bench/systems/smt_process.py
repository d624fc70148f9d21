"""SMT process proofs (the reference's ``src/bin/verify_smt_process.rs``):
each request is a batch of tree steps; each step is ``SparseMerkleTree.set``
and ``SparseMerkleProcessProofTarget.set_witness``, then one
``prove_batch`` proves the batch on the cell's card."""

from __future__ import annotations

import random

import torch

from port_bench.harness import proofs as hp
from port_bench.reference import smt as ref_smt
from port_bench.reference import verifier as ref_verifier


class SmtCircuit:
    """What the circuit cache keeps: the circuit and its target bundle."""

    def __init__(self, data, target):
        self.data = data
        self.target = target


def circuit_config(cfg: dict, overrides: dict | None = None):
    from intmax_zkp_core_tpu_torch.engine.config import CircuitConfig, FriConfig

    cc = dict(cfg["circuit_config"])
    fri = {**cc.pop("fri"), **(overrides or {})}
    return CircuitConfig(**cc, fri=FriConfig(**fri))


class System:
    def __init__(self, cfg: dict, devices: list, cache_dir: str | None, rec, trace: bool,
                 overrides: dict | None = None):
        self.cfg, self.devices, self.rec, self.trace = cfg, devices, rec, trace
        self.cache_dir = cache_dir
        self.config = circuit_config(cfg, overrides)

    def setup(self, warm_requests) -> None:
        from intmax_zkp_core_tpu_torch import runtime
        from intmax_zkp_core_tpu_torch.bin.verify_smt_process import build_circuit
        from intmax_zkp_core_tpu_torch.engine.circuit_cache import load_or_build
        from intmax_zkp_core_tpu_torch.models.sparse_merkle_tree import SparseMerkleTree

        for device in self.devices:
            runtime.warmup(device)
        n_levels = self.cfg["n_levels"]
        with self.rec.span("circuit_load"):
            built = load_or_build(
                f"bench_smt_process_{n_levels}", self.config,
                lambda dev: SmtCircuit(*build_circuit(n_levels, self.config, dev)),
                cache_dir=self.cache_dir, device=self.devices[0])
        self.data, self.target = built.data, built.target
        self.tree = SparseMerkleTree()  # the warm batch's tree; the window starts empty
        with self.rec.span("warm"):
            self.serve(next(warm_requests))
        self.tree = SparseMerkleTree()

    def serve(self, ops) -> list:
        from intmax_zkp_core_tpu_torch.bin.verify_smt_process import step
        from intmax_zkp_core_tpu_torch.engine.prover import prove_batch

        with self.rec.span("app"):
            pws = [step(self.tree, self.target, key, value)[1] for key, value in ops]
        timings = {} if self.trace else None
        with self.rec.span("prove"):
            out = prove_batch(self.data, pws, timings=timings)
            for device in self.devices:
                if device.type == "cuda":
                    torch.cuda.synchronize(device)
        self.rec.add_phases(timings)
        self.rec.count("proofs", len(ops))
        return out

    def work(self, ops, out) -> list:
        """The roofline work of one served request."""
        from port_bench.harness.roofline import batch_work

        return batch_work(hp.shape(self.data.common, self.config), len(out),
                          [int(p.fri.pow_witness) for p in out])

    def plain_outputs(self, outputs) -> list:
        return [(ops, [hp.plain(p) for p in out]) for ops, out in outputs]

    def verifier_key(self) -> dict:
        return hp.verifier_key(self.cfg["verifier_key"], self.cfg["circuit_config"]["fri"],
                               self.cfg["circuit_config"], self.data.common)

    def release(self) -> None:
        self.data = self.target = self.tree = None


def judge(key: dict, outputs: list, seed, rounds: int) -> dict:
    """Hold the outputs, in the order served, to the plain reference:
    ``missing``, the steps whose proof never came; ``statement``, the proofs
    whose public inputs (old root, new root) differ from the reference tree's;
    ``rejected``, the proofs the plain verifier rejects of those it verifies:
    in each of ``rounds`` rounds, the proof at each lane of the batch, each
    from a batch drawn from the seed, so that a fault at any lane shows.
    Each is an exact count, its limit 0."""
    tree = ref_smt.SparseMerkleTree()
    missing = statement = 0
    for ops, proofs in outputs:
        missing += max(0, len(ops) - len(proofs))
        statement += max(0, len(proofs) - len(ops))
        for i, (k, v) in enumerate(ops):
            old = tree.root()
            new = tree.set(k, v)
            if i < len(proofs) and proofs[i]["public_inputs"] != list(old) + list(new):
                statement += 1
    rng = random.Random(f"{seed}:judge")
    lanes = max((len(proofs) for _, proofs in outputs), default=0)
    jobs = []
    for _ in range(rounds):
        for lane in range(lanes):
            batches = [proofs for _, proofs in outputs if lane < len(proofs)]
            jobs.append((key, rng.choice(batches)[lane]))
    rejected = ref_verifier.count_rejected(jobs)
    attempted = sum(len(ops) for ops, _ in outputs)
    return {"attempted": attempted, "failed": min(attempted, missing + statement + rejected),
            "checks": {"missing": (missing, 0), "statement": (statement, 0),
                       "rejected": (rejected, 0)}}
