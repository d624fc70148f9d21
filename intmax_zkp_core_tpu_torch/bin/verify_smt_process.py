"""In-circuit SMT process-proof loop (reference
``src/bin/verify_smt_process.rs:24-114``; the reference loops without end at
N_LEVELS=256): build the process-proof circuit at
``standard_recursion_config``, then set random keys to random values in a
sparse Merkle tree and prove and verify each step's process proof.

    python -m intmax_zkp_core_tpu_torch.bin.verify_smt_process [n_iters] [n_levels] [seed]

``main`` runs the reference's mix (``operations``): each step sets a random
key to a random value, an insert, or an update where the key was set before.
Keys stay below 2^min(n_levels - 1, 30), as in the reference's loop, so every
key's path fits the circuit's depth.  Keys and values come from
``random.Random(seed)``, so the same operations can be replayed through
another implementation of the tree.

``role_cycle`` is not the reference's mix and ``main`` does not run it: it
gives steps that take a process proof through each of its roles in turn
(insert into the empty tree, insert beside a leaf, update, remove, no-op),
for the tests and the card check.
"""

from __future__ import annotations

import random
import sys
import time

P = 0xFFFFFFFF00000001
ROLES = ("insert", "insert", "update", "remove", "noop")


def key_bits(n_levels: int) -> int:
    return min(n_levels - 1, 30)


def operations(n_iters: int, n_levels: int, seed: int) -> list:
    """The reference loop's ``n_iters`` steps ``(key, value)``: a random key
    (an int, the digest ``HashOut.from_u32(key)``) set to a random value of 4
    field elements."""
    rng = random.Random(seed)
    return [(rng.randrange(1 << key_bits(n_levels)), tuple(rng.randrange(P) for _ in range(4)))
            for _ in range(n_iters)]


def role_cycle(n_iters: int, n_levels: int, seed: int) -> list:
    """``n_iters`` steps ``(key, value)`` through the roles ``ROLES`` in
    turn: the key an int (the digest ``HashOut.from_u32(key)``), the value 4
    field elements (all zero removes the key, or is a no-op where the key is
    absent)."""
    rng = random.Random(seed)
    live, used, ops = [], set(), []

    def fresh():
        while True:
            key = rng.randrange(1 << key_bits(n_levels))
            if key not in used:
                used.add(key)
                return key

    for i in range(n_iters):
        role = ROLES[i % len(ROLES)]
        value = tuple(rng.randrange(1, P) for _ in range(4))
        if role == "insert" or not live:
            key = fresh()
            live.append(key)
        elif role == "update":
            key = live[rng.randrange(len(live))]
        elif role == "remove":
            key = live.pop(rng.randrange(len(live)))
            value = (0, 0, 0, 0)
        else:
            key, value = fresh(), (0, 0, 0, 0)
        ops.append((key, value))
    return ops


def build_circuit(n_levels: int, config=None, device=None):
    """The process-proof circuit of depth ``n_levels`` with the old and new
    roots as public inputs: ``(CircuitData, SparseMerkleProcessProofTarget)``.
    ``config`` defaults to ``standard_recursion_config``; ``device=None`` is
    the CUDA device (raises without one)."""
    from ..engine.circuit import CircuitBuilder
    from ..engine.config import CircuitConfig
    from ..models.sparse_merkle_tree.gadgets import SparseMerkleProcessProofTarget

    builder = CircuitBuilder(config or CircuitConfig.standard_recursion_config(), device=device)
    target = SparseMerkleProcessProofTarget.add_virtual_to(builder, n_levels)
    builder.register_public_inputs(list(target.old_root))
    builder.register_public_inputs(list(target.new_root))
    return builder.build(), target


def step(tree, target, key: int, value):
    """Set ``key`` to ``value`` in ``tree``: the process proof and the
    partial witness of the circuit's target."""
    from ..engine.witness import PartialWitness
    from ..utils.hash_out import HashOut

    proof = tree.set(HashOut.from_u32(key), HashOut(tuple(value)))
    pw = PartialWitness()
    target.set_witness(pw, proof)
    return proof, pw


def main(n_iters: int = 3, n_levels: int = 32, seed: int = 0, device=None) -> list:
    """Build, then prove and verify ``n_iters`` steps; returns the proofs."""
    from ..models.sparse_merkle_tree import SparseMerkleTree

    print(f"building SMT process circuit at n_levels={n_levels}", flush=True)
    t0 = time.time()
    data, target = build_circuit(n_levels, device=device)
    print(f"built in {time.time() - t0:.1f}s; rows={data.common.n}", flush=True)
    tree = SparseMerkleTree()
    proofs = []
    for i, (key, value) in enumerate(operations(n_iters, n_levels, seed)):
        proof, pw = step(tree, target, key, value)
        t0 = time.time()
        zk_proof = data.prove(pw)
        data.verify(zk_proof)
        proofs.append(zk_proof)
        print(
            f"iter {i}: {proof.fnc.name} proved+verified in {time.time() - t0:.1f}s",
            flush=True,
        )
    return proofs


if __name__ == "__main__":
    main(*(int(a) for a in sys.argv[1:4]))
