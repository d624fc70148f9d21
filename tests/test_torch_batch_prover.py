"""The port's batch prover, proof-level helpers and batch Merkle builders:
the port version of ``test_batch_prover.py``.

``prove_batch`` of K = 3 witnesses equals three ``prove`` calls field by
field, on the arithmetic circuit and on zkDSA at ``FriConfig(
num_query_rounds=6, proof_of_work_bits=4)``; K = 1 equals ``prove``; every
proof verifies.  ``prove_many`` gives the same proofs on the CPU, where it
is ``prove_batch`` as on the card.  The batch builders
of ``ops/merkle.py`` equal the JAX package's ``build_merkle_levels_batch`` /
``build_merkle_trees_batch`` on seeded leaves [K, m, w], w in {4, 8, 135},
in both sponge wirings, and K single-tree builds.  Tolerance 0.
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from intmax_zkp_core_tpu.ops import merkle as jmk
from intmax_zkp_core_tpu_torch.engine.batch_prover import prove_batch
from intmax_zkp_core_tpu_torch.engine.circuit import CircuitBuilder
from intmax_zkp_core_tpu_torch.engine.config import CircuitConfig, FriConfig
from intmax_zkp_core_tpu_torch.engine.witness import PartialWitness
from intmax_zkp_core_tpu_torch.models.zkdsa.circuits import make_simple_signature_circuit
from intmax_zkp_core_tpu_torch.ops import goldilocks as gl
from intmax_zkp_core_tpu_torch.ops import merkle as tmk
from intmax_zkp_core_tpu_torch.parallel import prove_many
from intmax_zkp_core_tpu_torch.utils.hash_out import HashOut

torch.set_num_threads(1)

P = 0xFFFFFFFF00000001


def tiny_config():
    return CircuitConfig(fri=FriConfig(num_query_rounds=6, proof_of_work_bits=4))


class Arith:
    """x * y + x with x, y, the result public (``test_batch_prover.py``)."""

    def __init__(self):
        builder = CircuitBuilder(tiny_config(), device="cpu")
        self.x, self.y = builder.add_virtual_target(), builder.add_virtual_target()
        z = builder.add(builder.mul(self.x, self.y), self.x)
        for t in (self.x, self.y, z):
            builder.register_public_input(t)
        self.data = builder.build()

    def set(self, pw, xv, yv):
        pw.set_target(self.x, xv)
        pw.set_target(self.y, yv)

    def witness(self, xv, yv):
        pw = PartialWitness()
        self.set(pw, xv, yv)
        return pw


ARITH_WITNESSES = [(3, 5), (7, 11), (0, 123)]


@pytest.fixture(scope="module")
def arith():
    """The circuit, its three witnesses, their sequential proofs, and one
    batch of the three with its ``timings``."""
    circuit = Arith()
    pws = [circuit.witness(*v) for v in ARITH_WITNESSES]
    timings = {}
    batch = prove_batch(circuit.data, pws, timings=timings)
    return circuit, pws, [circuit.data.prove(pw) for pw in pws], batch, timings


@pytest.fixture(scope="module")
def zkdsa():
    circuit = make_simple_signature_circuit(tiny_config(), device="cpu")
    pws = []
    for sk, msg in ((41, 5), (43, 6), (47, 7)):
        pw = PartialWitness()
        circuit.targets.set_witness(pw, HashOut.from_u64(sk), HashOut.from_u64(msg))
        pws.append(pw)
    return circuit, pws, [circuit.data.prove(pw) for pw in pws]


def test_batch_matches_sequential_bitwise(arith):
    circuit, pws, sequential, batch, _ = arith
    assert len(batch) == len(pws)
    for (xv, yv), bp, sp in zip(ARITH_WITNESSES, batch, sequential):
        assert bp == sp
        assert bp.public_inputs == [xv, yv, (xv * yv + xv) % P]
        circuit.data.verify(bp)


def test_batch_single_proof(arith):
    circuit, pws, sequential, _, _ = arith
    (proof,) = prove_batch(circuit.data, pws[1:2])
    assert proof == sequential[1]


def test_batch_proofs_differ_per_witness(arith):
    # each proof keeps its own transcript: three witnesses, three transcripts
    sequential = arith[2]
    caps = {tuple(map(tuple, p.wires_cap)) for p in sequential}
    assert len(caps) == len(sequential)


def test_batch_zkdsa_circuit(zkdsa):
    circuit, pws, sequential = zkdsa
    proofs = prove_batch(circuit.data, pws)
    for proof, sp in zip(proofs, sequential):
        assert proof == sp
        circuit.data.verify(proof)


def test_batch_timings_have_the_phases_of_prove(arith):
    timings = arith[4]
    phases = ("tables", "witness", "commit_wires", "perm_columns", "quotient", "openings", "fri")
    parts = {
        "quotient": ("quotient_perm", "quotient_gates", "quotient_finish", "quotient_commit"),
        "fri": ("fri_combine", "fri_initial", "fri_fold", "fri_grind", "fri_queries"),
    }
    assert set(timings) == set(phases) | {p for ps_ in parts.values() for p in ps_}
    for phase, names in parts.items():
        assert sum(timings[n] for n in names) == pytest.approx(timings[phase], abs=1e-9)


def test_batch_refuses_no_witness(arith):
    with pytest.raises(ValueError):
        prove_batch(arith[0].data, [])


def test_prove_many_and_prove_group_on_the_cpu(arith):
    """``prove_many`` batches on the CPU as on the card (the block flow's
    groups call ``prove_batch`` directly): its proofs are the sequential
    ones, and no witness gives no proof."""
    circuit, _, sequential, _, _ = arith
    fns = [lambda pw, v=v: circuit.set(pw, *v) for v in ARITH_WITNESSES]
    assert prove_many(circuit, fns[:2]) == sequential[:2]
    assert prove_many(circuit, []) == []


# --------------------------------------------------------------------------
# batch Merkle builders
# --------------------------------------------------------------------------


def _leaves(K, m, w, seed):
    return np.random.default_rng(seed).integers(0, P, size=(K, m, w), dtype=np.uint64)


@functools.lru_cache(maxsize=None)
def _jax_batch(K, m, width, cap_height):
    """The JAX package's levels and trees of ``_leaves(K, m, width, width)``,
    made once per shape (both wirings are held against them)."""
    leaves = jnp.asarray(_leaves(K, m, width, width))
    levels = [np.asarray(lv) for lv in jmk.build_merkle_levels_batch(leaves, cap_height)]
    trees = [[np.asarray(lv) for lv in t.levels]
             for t in jmk.build_merkle_trees_batch(leaves, cap_height)]
    return levels, trees


@pytest.mark.parametrize("fused_sponge", [False, True], ids=["chained", "fused"])
@pytest.mark.parametrize("width", [4, 8, 135])
def test_batch_merkle_builders_equal_jax(width, fused_sponge):
    K, m, cap_height = 3, 16, 2
    leaves = _leaves(K, m, width, width)
    want, j_trees = _jax_batch(K, m, width, cap_height)
    # the prover hands the builder each proof's LDE transposed: [K, w, m] -> [K, m, w]
    cols = gl.from_u64(np.ascontiguousarray(leaves.transpose(0, 2, 1)), "cpu")
    got = tmk.build_merkle_levels_batch(cols.transpose(1, 2), cap_height, fused_sponge=fused_sponge)
    assert [tuple(lv.shape) for lv in got] == [lv.shape for lv in want]
    for g, w in zip(got, want):
        assert (gl.to_u64(g) == w).all()

    t_trees = tmk.build_merkle_trees_batch(leaves, cap_height, device="cpu",
                                           fused_sponge=fused_sponge)
    d_trees = tmk.device_merkle_trees_batch(leaves, cap_height, device="cpu",
                                            fused_sponge=fused_sponge)
    for k, (jt, tt, dt) in enumerate(zip(j_trees, t_trees, d_trees)):
        single = tmk.build_merkle_tree(leaves[k], cap_height, device="cpu")
        for lv_j, lv_t, lv_s in zip(jt, tt.levels, single.levels):
            assert (lv_t == lv_j).all() and (lv_s == lv_t).all()
        assert (dt.cap == tt.cap).all()
        idx = [0, 5, m - 1]
        for q, path in zip(idx, gl.to_u64(torch.stack(dt.path_gathers(idx), dim=1))):
            assert [tuple(d) for d in path] == [tuple(d) for d in tt.prove(q)]
            assert tmk.verify_merkle_proof(leaves[k, q], q, tt.prove(q), tt.cap)
