"""The roofline's work counts: hand-worked at a small shape, and the shapes
they are counted from against the commitments and transforms a CPU
``prove_batch`` makes."""

import pytest
import torch

from port_bench.harness import roofline as rl

SHAPE = {"n": 256, "num_wires": 135, "num_routed_wires": 80, "num_challenges": 2, "rate_bits": 3,
         "cap_height": 4, "final_poly_len": 32, "poseidon_gate": True}


def test_hand_counts():
    # a tree of 2048 leaves of 135 elements to a cap of 16: 17 permutations a
    # leaf, 2032 two-to-one nodes
    b, m = rl.merkle_tree(2048, 135, 4)
    assert m == (2048 * 17 + 2032) * rl.MADS_PER_PERMUTATION
    assert b == 2048 * 139 * 8 + 2032 * 12 * 8
    # a leaf of 4 elements is not hashed
    assert rl.merkle_tree(1024, 4, 4)[1] == 1008 * rl.MADS_PER_PERMUTATION
    # [3, 8] transform: 8 * 3 elements read and written; 4 * 3 butterflies a row
    assert rl.ntt(3, 8) == (3 * 8 * 16, 3 * 4 * 3 * rl.MUL)
    assert rl.MADS_PER_PERMUTATION == 118 * 14 + 8 * 290 + 484 + 22 * 90
    # 1 / Z_H at 2048 points of 4 rows, 8 distinct values
    assert rl.zinv_mul(4, 2048, 8) == (9 * 2048 * 8, 8 * rl.CHAIN + 4 * 2048 * rl.MUL)


def test_batch_calls_at_the_smt8_shape():
    calls = rl.batch_calls(SHAPE, 2, [5, 7])
    trees = sorted(args for stage, fn, args in calls if fn == "merkle_tree")
    # 2 proofs: wires (135), Z + partial products (24), quotient chunks (16)
    # over 2048 leaves, FRI layers of 1024 and 512 leaves down to 256 points
    assert trees == sorted([(2048, 135, 4)] * 2 + [(2048, 24, 4)] * 2 + [(2048, 16, 4)] * 2
                           + [(1024, 4, 4)] * 2 + [(512, 4, 4)] * 2 + [(256, 4, 4)] * 2)
    grind = [args for stage, fn, args in calls if fn == "poseidon_rows"]
    assert grind == [(6, 2, 4, 1), (8, 2, 4, 1)]
    ntts = sorted(args for stage, fn, args in calls if fn == "ntt")
    assert ntts == sorted([(270, 256), (270, 2048), (48, 256), (48, 2048), (4, 2048), (32, 2048)])
    work = rl.batch_work(SHAPE, 2, [5, 7])
    assert len(work) == len(calls) and all(b > 0 and m > 0 for _, b, m in work)


@pytest.fixture(scope="module")
def recorded():
    """The trees and transforms of one CPU prove_batch of 2 SMT steps at
    n_levels=8."""
    from intmax_zkp_core_tpu_torch.bin.verify_smt_process import build_circuit, operations, step
    from intmax_zkp_core_tpu_torch.engine import prover as prover_mod
    from intmax_zkp_core_tpu_torch.models.sparse_merkle_tree import SparseMerkleTree
    from intmax_zkp_core_tpu_torch.ops import merkle as mk
    from intmax_zkp_core_tpu_torch.ops import ntt as nt

    data, target = build_circuit(8, device=torch.device("cpu"))
    tree = SparseMerkleTree()
    pws = [step(tree, target, k, v)[1] for k, v in operations(2, 8, 11)]
    seen = {"trees": [], "ntt": []}
    mp = pytest.MonkeyPatch()
    # every tree, FRI layers included, is built by build_merkle_levels_batch
    levels, fwd, inv = mk.build_merkle_levels_batch, nt.ntt, nt.intt

    def rec_levels(leaves, cap_height, *a, **k):
        seen["trees"] += [(leaves.shape[1], leaves.shape[2], cap_height)] * leaves.shape[0]
        return levels(leaves, cap_height, *a, **k)

    def rec(fn):
        def wrapped(a, *args, **kw):
            seen["ntt"].append((a.numel() // a.shape[-1], a.shape[-1]))
            return fn(a, *args, **kw)
        return wrapped

    mp.setattr(mk, "build_merkle_levels_batch", rec_levels)
    mp.setattr(nt, "ntt", rec(fwd))
    mp.setattr(nt, "intt", rec(inv))
    try:
        proofs = prover_mod.prove_batch(data, pws, device=torch.device("cpu"))
    finally:
        mp.undo()
    return seen, [int(p.fri.pow_witness) for p in proofs]


def test_counted_shapes_are_the_provers(recorded):
    seen, nonces = recorded
    calls = rl.batch_calls(SHAPE, 2, nonces)
    assert sorted(seen["trees"]) == sorted(a for _, fn, a in calls if fn == "merkle_tree")
    counted = sorted(a for _, fn, a in calls if fn == "ntt")
    extra = list(seen["ntt"])
    for shape in counted:
        extra.remove(shape)  # every counted transform is made
    # what is left is the final polynomial's inverse transform, not counted
    assert extra == [(4, 256)]
