"""The port's host C++ (``intmax_zkp_core_tpu_torch/native/``) against its
plain Python versions and the JAX package, tolerance 0.

* The native permutation and sponge equal the port's ``permute_s`` and the
  sponge's Python body, and the JAX package's ``permute_s`` and sponge, on
  seeded states and on edge lanes (0, 1, 2^32 - 1, 2^32, 2^63, p - 1).
* The native witness fill gives the same wire matrix and public inputs as the
  port's ``WitnessFill`` (``compute_wire_matrix_plain``) and as
  the JAX package's ``compute_wire_matrix`` run on the same circuit (the
  port's prover data, copied so that the JAX fill plan lands on the copy):
  the SMT process circuit at depth 16, the 64-row hash chain, zkDSA, a
  circuit of u32_mul_add and ext_inverse records and a circuit with a Python
  kind interleaved.  That the two builders emit the same circuits is held by
  ``test_torch_prover.py`` (zkDSA, chain) and ``test_torch_smt.py`` (SMT).
* A conflicting witness raises; a failed build raises and nothing falls back
  to Python.
"""

import copy

import numpy as np
import pytest
import torch

from intmax_zkp_core_tpu.engine import generators as jgen
from intmax_zkp_core_tpu.engine import prover as jprover
from intmax_zkp_core_tpu.ops import poseidon as jps
from intmax_zkp_core_tpu_torch.bin import verify_smt_process as vsp
from intmax_zkp_core_tpu_torch.engine import generators as tgen
from intmax_zkp_core_tpu_torch.engine import prover as tprover
from intmax_zkp_core_tpu_torch.engine.circuit import CircuitBuilder
from intmax_zkp_core_tpu_torch.engine.config import CircuitConfig
from intmax_zkp_core_tpu_torch.engine.witness import PartialWitness
from intmax_zkp_core_tpu_torch.models.hash_chain import make_hash_chain_circuit
from intmax_zkp_core_tpu_torch.models.sparse_merkle_tree import SparseMerkleTree
from intmax_zkp_core_tpu_torch.models.zkdsa import make_simple_signature_circuit
from intmax_zkp_core_tpu_torch.native import loader
from intmax_zkp_core_tpu_torch.native import witness as nw
from intmax_zkp_core_tpu_torch.ops import poseidon as ps
from intmax_zkp_core_tpu_torch.utils.hash_out import HashOut

torch.set_num_threads(1)

P = 0xFFFFFFFF00000001
EDGE_LANES = (0, 1, (1 << 32) - 1, 1 << 32, 1 << 63, P - 1)
W_EXT = 7  # the extension field x^2 - 7 of the recursion gadgets


def _inputs(seed, n, width):
    """``n`` rows of ``width`` field elements: seeded rows, then rows of each
    edge lane alone and a row cycling through all of them."""
    rng = np.random.default_rng(seed)
    rows = [[int(v) for v in r] for r in rng.integers(0, P, size=(n, width), dtype=np.uint64)]
    rows += [[v] * width for v in EDGE_LANES]
    rows.append([EDGE_LANES[i % len(EDGE_LANES)] for i in range(width)])
    return rows


def test_native_permutation_equals_permute_s_and_jax():
    states = _inputs(1, 64, 12)
    batch = loader.native_permute_batch(states)
    for state, got in zip(states, batch):
        want = ps.permute_s(state)
        assert [int(v) for v in got] == want == jps.permute_s(state)
        assert ps.permute_host(state) == want


@pytest.mark.parametrize("width", range(26))
def test_native_sponge_equals_python_sponge_and_jax(width):
    for row in _inputs(100 + width, 8, width):
        want = ps.hash_n_to_m_no_pad_plain_s(row, 4)
        assert ps.hash_n_to_m_no_pad_s(row) == want == jps.hash_n_to_m_no_pad_s(row)
        assert ps.hash_no_pad_s(row) == want
        # other output counts stay on the Python sponge, as in the JAX package
        assert ps.hash_n_to_m_no_pad_s(row, 8) == jps.hash_n_to_m_no_pad_s(row, 8)


def _fills(data, pw):
    """(wires, public inputs) of the native fill, the port's WitnessFill and
    the JAX package's compute_wire_matrix on the same circuit."""
    pd = data.prover
    native = tprover.compute_wire_matrix(pd, pw)
    python = tprover.compute_wire_matrix_plain(pd, pw)
    view = copy.copy(pd)
    view.__dict__.pop("_fill_plan", None)
    jax = jprover.compute_wire_matrix(view, pw)
    return native, python, jax


def _assert_equal_fills(data, pw):
    (w1, pi1), (w2, pi2), (w3, pi3) = _fills(data, pw)
    assert w1.dtype == w2.dtype == np.uint64
    assert (w1 == w2).all() and (w1 == np.asarray(w3)).all()
    assert [int(v) for v in pi1] == [int(v) for v in pi2] == [int(v) for v in pi3]
    return w1


def test_smt_process_circuit_depth_16():
    """arith / split_le / poseidon / inv_or_zero records, every role."""
    data, target = vsp.build_circuit(16, CircuitConfig.test_config(), device="cpu")
    tree = SparseMerkleTree()
    for key, value in vsp.role_cycle(5, 16, seed=3):
        _, pw = vsp.step(tree, target, key, value)
        _assert_equal_fills(data, pw)
    assert hasattr(data.prover, "_fill_plan")  # built once, then cached


def test_hash_chain_64_rows():
    chain = make_hash_chain_circuit(60, CircuitConfig.test_config(), device="cpu")
    assert chain.data.common.n == 64
    _assert_equal_fills(chain.data, chain.witness(HashOut.from_u64(7), HashOut.from_u64(0xC0FFEE)))


def test_zkdsa():
    circuit = make_simple_signature_circuit(CircuitConfig.test_config(), device="cpu")
    pw = PartialWitness()
    circuit.targets.set_witness(pw, HashOut.from_u64(42), HashOut.from_u64(0xABCDEF))
    _assert_equal_fills(circuit.data, pw)


def test_u32_mul_add_and_ext_inverse_records():
    b = CircuitBuilder(CircuitConfig.test_config(), device="cpu")
    xs = [b.add_virtual_target() for _ in range(5)]
    outs = []
    for i in range(4):  # two gate rows of u32_mul_add
        outs += b.u32_mul_add(xs[i], xs[i + 1], xs[(i + 2) % 5])
    # the record the recursion gadgets append for an extension-field inverse
    inv0, inv1 = b.add_virtual_target(), b.add_virtual_target()
    b.generators.append(("ext_inverse", xs[0], xs[1], inv0, inv1, W_EXT))
    b.register_public_inputs(outs + [inv0, inv1])
    data = b.build()
    assert {rec[0] for rec in data.prover.generators} >= {"u32_mul_add", "ext_inverse"}
    pw = PartialWitness()
    for t, v in zip(xs, (0xFFFFFFFF, 0x12345678, 0, 0xDEADBEEF, 1)):
        pw.set_target(t, v)
    wires = _assert_equal_fills(data, pw)
    assert wires.any()


def _double_plus_one(w, src, out):
    v = w.get(src)
    if v is None:
        return False
    w.set(out, (2 * v + 1) % P)
    return True


def test_python_kind_interleaved(monkeypatch):
    """A kind that only Python knows sits between native records: the
    native pass stops at it, Python fills it, the native pass resumes."""
    for registry in (tgen.GENERATOR_KINDS, jgen.GENERATOR_KINDS):
        monkeypatch.setitem(registry, "test_double_plus_one", _double_plus_one)
    b = CircuitBuilder(CircuitConfig.test_config(), device="cpu")
    x = b.add_virtual_target()
    cur = b.mul(x, x)
    for _ in range(3):
        nxt = b.add_virtual_target()
        b.generators.append(("test_double_plus_one", cur, nxt))
        cur = b.add(b.mul(nxt, nxt), x)
    b.register_public_inputs([cur])
    data = b.build()
    plan = nw.get_fill_plan(data.prover)
    assert len(plan.python_records) == 3 and plan.n_records > 0
    pw = PartialWitness()
    pw.set_target(x, 5)
    _assert_equal_fills(data, pw)
    want = 25
    for _ in range(3):
        want = ((2 * want + 1) ** 2 + 5) % P
    assert tprover.compute_wire_matrix(data.prover, pw)[1] == [want]


def test_conflicting_witness_raises():
    b = CircuitBuilder(CircuitConfig.test_config(), device="cpu")
    a, c = b.add_virtual_target(), b.add_virtual_target()
    b.connect(a, c)
    b.register_public_inputs([a])
    data = b.build()
    pw = PartialWitness()
    pw.set_target(a, 1)
    pw.set_target(c, 2)
    with pytest.raises(AssertionError, match="conflicting witness values"):
        tprover.compute_wire_matrix(data.prover, pw)


def test_failed_build_raises_and_nothing_falls_back(monkeypatch, tmp_path):
    monkeypatch.setattr(loader, "BUILD_DIR", str(tmp_path / "_build"))
    monkeypatch.setattr(loader, "CXX", str(tmp_path / "no-such-compiler"))
    monkeypatch.setattr(loader, "_libs", {})
    with pytest.raises(RuntimeError, match="no-such-compiler"):
        ps.permute_host([0] * 12)
    with pytest.raises(RuntimeError, match="no-such-compiler"):
        ps.hash_no_pad_s([1, 2, 3])
    with pytest.raises(RuntimeError, match="no-such-compiler"):
        loader.witness_lib()
    assert not any(p.suffix == ".so" for p in (tmp_path / "_build").iterdir())


def test_compiler_errors_reach_the_exception(monkeypatch, tmp_path):
    bad = tmp_path / "broken.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(loader, "BUILD_DIR", str(tmp_path / "_build"))
    monkeypatch.setitem(loader.SOURCES, "poseidon", str(bad))
    monkeypatch.setattr(loader, "_libs", {})
    with pytest.raises(RuntimeError, match="error") as info:
        loader.load("poseidon")
    assert "broken.cpp" in str(info.value)


def test_library_name_carries_source_flags_and_cpu(monkeypatch):
    path = loader.library_path("poseidon")
    monkeypatch.setattr(loader, "CXX_FLAGS", loader.CXX_FLAGS + ["-DX"])
    assert loader.library_path("poseidon") != path
    monkeypatch.setattr(loader, "_cpu_model", lambda: "another cpu")
    assert len({path, loader.library_path("poseidon")}) == 2
