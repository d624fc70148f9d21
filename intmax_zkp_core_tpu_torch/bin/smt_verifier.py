"""Out-of-circuit SMT process-proof check loop (reference
``src/bin/smt_verifier.rs:6-36``): random sets in a sparse Merkle tree, each
process proof checked by the circomlib state machine.

    python -m intmax_zkp_core_tpu_torch.bin.smt_verifier [n_iters] [seed]

Keys and values come from ``random.Random(seed)``.  The tree's hashing is
host C++ (``native/``) and nothing runs on the device, but the loop keeps the
port's device rule: ``device=None`` is the CUDA device and raises without
one; pass ``device="cpu"`` to run on a machine without a card.
"""

from __future__ import annotations

import random
import sys

P = 0xFFFFFFFF00000001


def main(n_iters: int = 10, seed: int = 0, device=None) -> list:
    """Returns the process proofs."""
    from ..models.sparse_merkle_tree import SparseMerkleTree
    from ..ops.goldilocks import resolve_device
    from ..utils.hash_out import HashOut

    resolve_device(device)

    rng = random.Random(seed)

    def rand_hash():
        return HashOut(tuple(rng.randrange(P) for _ in range(4)))

    tree = SparseMerkleTree()
    keys, proofs = [], []
    for i in range(n_iters):
        if keys and rng.random() < 0.3:
            key = rng.choice(keys)
        else:
            key = rand_hash()
            keys.append(key)
        value = HashOut.ZERO if rng.random() < 0.3 else rand_hash()
        proof = tree.set(key, value)
        proof.check()
        proofs.append(proof)
        print(f"iter {i}: {proof.fnc.name} ok; root {tree.get_root().to_hex()[:18]}…")
    return proofs


if __name__ == "__main__":
    main(*(int(a) for a in sys.argv[1:3]))
