"""The port's multi-device layer against the JAX package's: the port version
of ``test_parallel.py``.

The JAX functions run on the JAX package's 8-device CPU mesh
(``make_mesh(8)``, the virtual devices of ``conftest.py``), each compiled as
one program (``jax.jit``); the port's run on CPU meshes of d shards
(``Mesh(["cpu"] * d)``), on the same seeded numpy inputs.  The sharded NTT,
LDE and Merkle levels, the distributed prove step, a zkDSA proof whose
commitments run over a commit mesh (equal to the one-device proof and the
JAX-made golden), ``prove_batch(mesh=)`` with padding and ``prove_many``
over a mesh equal the one-device results bit for bit (tolerance 0).
"""

import hashlib
import importlib
import json
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from intmax_zkp_core_tpu.ops import merkle as jmk
from intmax_zkp_core_tpu.parallel.mesh import make_mesh as jax_make_mesh
from intmax_zkp_core_tpu.parallel.prove_step import (
    make_distributed_prove_step as jax_prove_step,
)
from intmax_zkp_core_tpu_torch.engine import prover as tprover
from intmax_zkp_core_tpu_torch.engine.batch_prover import prove_batch
from intmax_zkp_core_tpu_torch.engine.config import CircuitConfig, FriConfig
from intmax_zkp_core_tpu_torch.engine.serde import proof_to_json
from intmax_zkp_core_tpu_torch.engine.witness import PartialWitness
from intmax_zkp_core_tpu_torch.models.zkdsa.circuits import make_simple_signature_circuit
from intmax_zkp_core_tpu_torch.ops import goldilocks as gl
from intmax_zkp_core_tpu_torch.ops import merkle as tmk
from intmax_zkp_core_tpu_torch.ops import ntt as tnt
from intmax_zkp_core_tpu_torch.parallel import prove_many
from intmax_zkp_core_tpu_torch.parallel.mesh import (
    SHARD_COMMIT_MIN_LDE,
    Mesh,
    commit_mesh,
    default_mesh,
    gather,
    init_distributed,
    make_mesh,
    use_commit_mesh,
)
from intmax_zkp_core_tpu_torch.parallel.prove_step import make_distributed_prove_step
from intmax_zkp_core_tpu_torch.utils.hash_out import HashOut

# the packages export a function named like the module ``ntt_sharded``
jns = importlib.import_module("intmax_zkp_core_tpu.parallel.ntt_sharded")
jms = importlib.import_module("intmax_zkp_core_tpu.parallel.merkle_sharded")
tns = importlib.import_module("intmax_zkp_core_tpu_torch.parallel.ntt_sharded")
tms = importlib.import_module("intmax_zkp_core_tpu_torch.parallel.merkle_sharded")

torch.set_num_threads(1)

P = 0xFFFFFFFF00000001
ROOT = pathlib.Path(__file__).resolve().parent.parent


def _field(seed, shape):
    return np.random.default_rng(seed).integers(0, P, size=shape, dtype=np.uint64)


def _u64(parts, dim):
    return gl.to_u64(gather(parts, dim, "cpu"))


@pytest.fixture(scope="module")
def jmesh():
    assert len(jax.devices()) >= 8
    return jax_make_mesh(8)


def cpu_mesh(d):
    return Mesh(["cpu"] * d)


def test_can_shard_and_twiddles_as_jax():
    for n in [0, 3, 1 << 5, 1 << 6, 1 << 7, 1 << 12, 1 << 19, 1 << 20]:
        for d in (1, 2, 3, 4, 8, 16):
            assert tns.can_shard(n, d) == jns.can_shard(n, d), (n, d)
            for cap in (0, 2, 4):
                assert tms.can_shard_tree(n, d, cap) == jms.can_shard_tree(n, d, cap), (n, d, cap)
    for log_n1, log_n2 in [(3, 3), (4, 5)]:
        assert (gl.to_u64(tns._twiddle_matrix(log_n1, log_n2))
                == jns._twiddle_matrix(log_n1, log_n2)).all()


@pytest.mark.parametrize("log_n", [6, 12])
def test_ntt_sharded_equals_jax_on_its_mesh(jmesh, log_n):
    x = _field(log_n, (1 << log_n,))
    want = np.asarray(jax.jit(lambda v: jns.ntt_sharded(v, jmesh))(jnp.asarray(x)))
    got = tns.ntt_sharded(gl.from_u64(x, "cpu"), cpu_mesh(8))
    assert len(got) == 8 and all(p.shape == (1 << (log_n - 3),) for p in got)
    assert (_u64(got, -1) == want).all()


@pytest.mark.parametrize("B,log_n,rate_bits", [(3, 7, 2), (2, 9, 3)])
def test_ntt_sharded_batch_and_coset_lde_equal_jax_on_its_mesh(jmesh, B, log_n, rate_bits):
    a = _field(B + log_n, (B, 1 << log_n))
    want_evals = np.asarray(jax.jit(lambda v: jns.ntt_sharded_batch(v, jmesh))(jnp.asarray(a)))
    want_lde = np.asarray(
        jax.jit(lambda v: jns.coset_lde_sharded(v, rate_bits, jmesh))(jnp.asarray(a)))
    at = gl.from_u64(a, "cpu")
    assert (_u64(tns.ntt_sharded_batch(at, cpu_mesh(8)), -1) == want_evals).all()
    assert (_u64(tns.coset_lde_sharded(at, rate_bits, cpu_mesh(8)), -1) == want_lde).all()
    for d in (2, 4):  # other shard counts give the same values
        assert torch.equal(gather(tns.coset_lde_sharded(at, rate_bits, cpu_mesh(d)), -1, "cpu"),
                           tnt.coset_lde(at, rate_bits))


@pytest.mark.parametrize("n,w,cap_height", [(64, 7, 1), (64, 9, 4)])
def test_merkle_levels_sharded_equal_jax_on_its_mesh(jmesh, n, w, cap_height):
    # cap_height 1 < log2(d) = 3: the top levels fold from the d block roots;
    # cap_height >= 3: every level stays sharded
    leaves = _field(n + w, (n, w))
    want = [np.asarray(lv) for lv in jax.jit(
        lambda v: jms.build_merkle_levels_sharded(v, cap_height, jmesh))(jnp.asarray(leaves))]
    before = tms.SHARDED_TREE_CALLS
    got = tms.build_merkle_levels_sharded(gl.from_u64(leaves, "cpu"), cap_height, cpu_mesh(8))
    assert tms.SHARDED_TREE_CALLS == before + 1
    assert len(got) == len(want) == len(jmk.build_merkle_levels(jnp.asarray(leaves), cap_height))
    for lg, lw in zip(got, want):
        assert len(lg) == (8 if lw.shape[0] >= 8 else 1)
        assert (_u64(lg, -2) == lw).all()
    # K trees of transposed leaves, given as parts, as the prover hands them over
    lde = gl.from_u64(_field(n, (2, w, n)), "cpu")
    parts = [p.transpose(1, 2) for p in lde.split(n // 4, dim=-1)]
    got = tms.build_merkle_levels_sharded(parts, cap_height, cpu_mesh(4))
    for lg, lw in zip(got, tmk.build_merkle_levels_batch(lde.transpose(1, 2), cap_height)):
        assert torch.equal(gather(lg, -2, "cpu"), lw)


@pytest.fixture(scope="module")
def jax_step(jmesh):
    states, poly = _field(1, (128, 12)), _field(2, (1 << 10,))
    return states, poly, [np.asarray(r) for r in jax_prove_step(jmesh)(
        jnp.asarray(states), jnp.asarray(poly))]


@pytest.mark.parametrize("d", [2, 4, 8])
def test_distributed_prove_step_equals_jax(jax_step, d):
    states, poly, (jh, je, jr) = jax_step
    hashed, evals, root = make_distributed_prove_step(cpu_mesh(d))(
        gl.from_u64(states, "cpu"), gl.from_u64(poly, "cpu"))
    assert len(hashed) == len(evals) == d
    assert (_u64(hashed, 0) == jh).all()
    assert (_u64(evals, -1) == je).all()
    assert (gl.to_u64(root) == jr).all()


def _sha(proof):
    return hashlib.sha256(json.dumps(proof_to_json(proof), sort_keys=True).encode()).hexdigest()


def test_commit_mesh_zkdsa_proof_equals_one_device_and_golden():
    circ = make_simple_signature_circuit(CircuitConfig.standard_recursion_config(), "cpu")
    pw = PartialWitness()
    circ.targets.set_witness(pw, HashOut.from_u64(42), HashOut.from_u64(0xABCDEF))
    plain = circ.data.prove(pw)
    before = tms.SHARDED_TREE_CALLS
    with use_commit_mesh(cpu_mesh(2), min_lde=1):
        assert commit_mesh().min_lde == 1
        sharded = circ.data.prove(pw)
    assert commit_mesh().mesh is None and commit_mesh().min_lde == SHARD_COMMIT_MIN_LDE
    assert tms.SHARDED_TREE_CALLS == before + 3  # wires, Z and partial products, quotient
    assert sharded == plain
    golden = (ROOT / "intmax_zkp_core_tpu_torch" / "golden" / "zkdsa_standard.sha256").read_text()
    assert _sha(sharded) == golden.split()[0]
    circ.data.verify(sharded)


def test_commit_mesh_threshold():
    cols = gl.from_u64(_field(4, (1, 3, 1 << 6)), "cpu")  # LDE 2^9
    want = tprover._commit_batch(cols, 3, 2)
    before = tms.SHARDED_TREE_CALLS
    for min_lde, sharded in ((1 << 10, 0), (1 << 9, 1)):
        with use_commit_mesh(cpu_mesh(4), min_lde=min_lde):
            got = tprover._commit_batch(cols, 3, 2)
        assert tms.SHARDED_TREE_CALLS == before + sharded
        assert torch.equal(got[1], want[1])
        got_levels, want_levels = got[2][0].levels, want[2][0].levels
        assert len(got_levels) == len(want_levels) == 8
        assert all(torch.equal(a, b) for a, b in zip(got_levels, want_levels))
        assert (got[2][0].cap == want[2][0].cap).all()


@pytest.fixture(scope="module")
def zkdsa():
    circ = make_simple_signature_circuit(
        CircuitConfig(fri=FriConfig(num_query_rounds=3, proof_of_work_bits=2)), "cpu")
    pws = []
    for i in range(5):
        pw = PartialWitness()
        circ.targets.set_witness(pw, HashOut.from_u64(41 + i), HashOut.from_u64(5 + i))
        pws.append(pw)
    return circ, pws, [circ.data.prove(pw) for pw in pws]


def test_prove_batch_over_a_mesh_pads_and_equals_sequential(zkdsa):
    circ, pws, sequential = zkdsa
    timings = {}
    proofs = prove_batch(circ.data, pws, mesh=cpu_mesh(4), timings=timings)  # K = 5 -> 8 lanes
    assert proofs == sequential
    assert set(timings) == {"witness", "prove", "gather"}
    for p in proofs:
        circ.data.verify(p)


def test_prove_many_over_a_mesh(zkdsa):
    circ, pws, sequential = zkdsa
    fns = [lambda pw, i=i: circ.targets.set_witness(pw, HashOut.from_u64(41 + i),
                                                     HashOut.from_u64(5 + i)) for i in range(2)]
    assert prove_many(circ, fns, mesh=cpu_mesh(2)) == sequential[:2]


def test_mesh_entry_points_and_limits():
    n = torch.cuda.device_count() if torch.cuda.is_available() else 0
    with pytest.raises(RuntimeError):
        make_mesh(n + 1)  # never falls back to the CPU
    if n == 0:
        with pytest.raises(RuntimeError):
            make_mesh()
        with pytest.raises(RuntimeError):
            init_distributed()
    assert default_mesh("cpu", 2) is None and default_mesh(None, 1) is None
    m1 = init_distributed(devices=["cpu", "cpu"])
    m2 = init_distributed(devices=["cpu", "cpu"])
    assert m1 == m2 == cpu_mesh(2)
    assert (m1.size, m1.process_count) == (2, 1)
    with pytest.raises(KeyError):
        use_commit_mesh(m1, "x").__enter__()
    with pytest.raises(KeyError):
        prove_batch(None, [], mesh=m1, axis_name="x")
    with pytest.raises(RuntimeError, match="init_distributed"):
        use_commit_mesh(Mesh(["cpu"], process_count=2)).__enter__()  # no process group
    assert commit_mesh().mesh is None
    x = gl.from_u64(_field(3, (1 << 5,)), "cpu")
    with pytest.raises(ValueError):
        tns.ntt_sharded(x, cpu_mesh(8))  # n1 = 4 does not split over 8 shards
    with pytest.raises(ValueError):
        tms.build_merkle_levels_sharded(x.reshape(8, 4), 4, cpu_mesh(2))  # cap finer than leaves

