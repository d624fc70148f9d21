"""The port's circuit cache (``engine/circuit_cache.py``) and the pickling of
its circuits (``ProverCircuitData.__getstate__`` / ``__setstate__``,
``CircuitData.__getstate__``): the port version of ``test_circuit_serde.py``.

A pickled circuit proves bit-identically; the pickle covers every generator
kind of the engine and the ECDSA model's Python kinds; ``load_or_build``
round-trips through its memo and through the disk.  Beyond the JAX tests: a
corrupted file raises; the memo is bounded and reads a replaced file again;
the pickle holds no torch object (no tensor, no device) and a loaded circuit
proves on the device its loader names; the block circuit's cache name
changes with an inner circuit's digest.  That a fresh interpreter which
unpickles the n_bits = 16 ECDSA circuit fills its witness (unpickling
imports the model, which registers its kinds) is tested in
``test_torch_ecdsa.py``, on the circuit that file builds.  All on the CPU;
the card loads a cached block flow in ``chip_smoke.py`` and
``test_torch_cuda.py``.
"""

import dataclasses
import io
import os
import pickle
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from intmax_zkp_core_tpu_torch.config import RollupConstants
from intmax_zkp_core_tpu_torch.engine import circuit_cache as cc
from intmax_zkp_core_tpu_torch.engine.circuit import CircuitBuilder
from intmax_zkp_core_tpu_torch.engine.config import CircuitConfig, FriConfig
from intmax_zkp_core_tpu_torch.engine.prover import compute_wire_matrix
from intmax_zkp_core_tpu_torch.engine.recursion import ExtTargetAlgebra
from intmax_zkp_core_tpu_torch.engine.witness import PartialWitness
from intmax_zkp_core_tpu_torch.models.ecdsa import gadgets as eg
from intmax_zkp_core_tpu_torch.models.ecdsa.account import N256
from intmax_zkp_core_tpu_torch.models.rollup.block_flow import block_circuit_name
from intmax_zkp_core_tpu_torch.models.sparse_merkle_tree import SparseMerkleTree
from intmax_zkp_core_tpu_torch.models.sparse_merkle_tree.gadgets.process import (
    SparseMerkleProcessProofTarget,
)
from intmax_zkp_core_tpu_torch.models.sparse_merkle_tree.node_data import (
    NodeDataMemory,
    RootDataTmp,
)
from intmax_zkp_core_tpu_torch.models.zkdsa.circuits import make_simple_signature_circuit
from intmax_zkp_core_tpu_torch.utils.hash_out import HashOut

CFG = CircuitConfig(fri=FriConfig(num_query_rounds=3, proof_of_work_bits=2))
CPU = torch.device("cpu")
ENGINE_KINDS = {"arith", "inv_or_zero", "split_le", "poseidon", "u32_mul_add", "ext_inverse"}
ECDSA_KINDS = {"ecdsa_biguint", "ecdsa_mul_quotient", "ecdsa_overflow_count"}



@pytest.fixture(autouse=True)
def empty_memo():
    cc._MEMO.clear()
    yield
    cc._MEMO.clear()


def _proof_fields(proof):
    return (proof.public_inputs, proof.wires_cap, proof.zs_pp_cap, proof.quotient_cap,
            proof.openings, dataclasses.asdict(proof.fri), proof.initial_openings)


def _build_zkdsa(device):
    return make_simple_signature_circuit(CFG, device)


@pytest.fixture(scope="module")
def zkdsa():
    return make_simple_signature_circuit(CFG, "cpu")


SK, MSG = HashOut.from_u64(42), HashOut.from_u64(0xABCDEF)


def test_pickled_circuit_proves_bit_identically(zkdsa):
    p1 = zkdsa.prove(SK, MSG)
    zkdsa.verify(p1)
    assert hasattr(zkdsa.data.prover, "_fill_plan")  # the proof attached its fill plan
    reloaded = pickle.loads(pickle.dumps(zkdsa))
    assert not hasattr(reloaded.data.prover, "_fill_plan")
    assert reloaded.data.device is None  # the loader names the device
    assert (reloaded.data.prover.cs_lde == zkdsa.data.prover.cs_lde).all()
    cc.bind_device(reloaded, "cpu")
    p2 = reloaded.prove(SK, MSG)
    reloaded.verify(p2)
    assert _proof_fields(p1) == _proof_fields(p2)


def test_reload_checks_the_cap(zkdsa):
    data = pickle.loads(pickle.dumps(zkdsa.data))
    data.common.constants_sigmas_cap[0] = (1, 2, 3, 4)
    with pytest.raises(ValueError):
        pickle.loads(pickle.dumps(data))


def _all_kinds_circuit():
    """One circuit with every engine generator kind (an SMT process proof at
    8 levels, an extension-field inverse, a u32 product) and the three ECDSA
    kinds (non-native multiply, add and subtract mod n), built at blowup 2:
    it is only checked."""
    cfg = CircuitConfig(fri=FriConfig(rate_bits=1, num_query_rounds=3, proof_of_work_bits=2))
    builder = CircuitBuilder(cfg, device="cpu")
    smt = SparseMerkleProcessProofTarget.add_virtual_to(builder, n_levels=8)
    ext = ExtTargetAlgebra(builder)
    e = (builder.add_virtual_target(), builder.add_virtual_target())
    ext_inv = ext.inverse(e)
    x, y = eg.add_virtual_biguint(builder), eg.add_virtual_biguint(builder)
    outs = [eg.mul_nonnative(builder, x, y, N256), eg.add_nonnative(builder, x, y, N256),
            eg.sub_nonnative(builder, x, y, N256)]
    for t in [*ext_inv, *(limb for big in outs for limb in big.limbs)]:
        builder.register_public_input(t)
    data = builder.build()

    def witness():
        pw = PartialWitness()
        tree = SparseMerkleTree(NodeDataMemory(), RootDataTmp())
        smt.set_witness(pw, tree.set(HashOut.from_u128(5), HashOut.from_u128(77)))
        pw.set_target(e[0], 3)
        pw.set_target(e[1], 5)
        eg.set_biguint_witness(pw, x, N256 - 12345)
        eg.set_biguint_witness(pw, y, 0xCAFE << 200)
        return pw
    return data, witness


def test_pickle_covers_every_generator_kind():
    data, witness = _all_kinds_circuit()
    kinds = {rec[0] for rec in data.prover.generators}
    assert ENGINE_KINDS | ECDSA_KINDS <= kinds
    assert all(isinstance(rec, tuple) for rec in data.prover.generators)
    pis = data.check_witness(witness())
    reloaded = cc.bind_device(pickle.loads(pickle.dumps(data)), "cpu")
    assert reloaded.check_witness(witness()) == pis
    wires, _ = compute_wire_matrix(data.prover, witness())
    reloaded_wires, _ = compute_wire_matrix(reloaded.prover, witness())
    assert (wires == reloaded_wires).all()


class _NoTorch(pickle.Unpickler):
    """Records every global a pickle names."""

    def __init__(self, data):
        super().__init__(io.BytesIO(data))
        self.modules = set()

    def find_class(self, module, name):
        self.modules.add(module)
        return super().find_class(module, name)


def test_pickle_holds_no_torch_object(zkdsa):
    zkdsa.prove(SK, MSG)  # the proof's caches are on the object now
    reader = _NoTorch(pickle.dumps(zkdsa, protocol=pickle.HIGHEST_PROTOCOL))
    reader.load()
    assert not any(m == "torch" or m.startswith("torch.") for m in reader.modules), reader.modules
    assert "numpy" in {m.split(".")[0] for m in reader.modules}  # the tables are numpy


def test_load_or_build_round_trip(tmp_path):
    calls = []

    def build(device):
        calls.append(device)
        return _build_zkdsa(device)

    c1 = cc.load_or_build("zkdsa-test", CFG, build, cache_dir=str(tmp_path), device="cpu")
    c2 = cc.load_or_build("zkdsa-test", CFG, build, cache_dir=str(tmp_path), device="cpu")
    assert calls == [CPU] and c2 is c1, "the second load must hit the in-process memo"
    cc._MEMO.clear()
    c3 = cc.load_or_build("zkdsa-test", CFG, build, cache_dir=str(tmp_path), device="cpu")
    assert calls == [CPU] and c3 is not c1, "the third load must come from disk"
    assert c3.data.device == CPU
    assert c3.data.common.circuit_digest == c1.data.common.circuit_digest
    sk, msg = HashOut.from_u64(3), HashOut.from_u64(9)
    assert _proof_fields(c1.prove(sk, msg)) == _proof_fields(c3.prove(sk, msg))
    (name,) = os.listdir(tmp_path)
    assert name == cc.key_of("zkdsa-test", CFG) + ".ckt"
    # no cache_dir: build every time, nothing kept
    c4 = cc.load_or_build("zkdsa-test", CFG, build, device="cpu")
    assert len(calls) == 2 and c4 is not c1 and not cc._MEMO.get(name)


def test_load_without_cuda_raises(tmp_path, zkdsa):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    cc.write_circuit(str(tmp_path / (cc.key_of("zkdsa-test", CFG) + ".ckt")), zkdsa)
    with pytest.raises(RuntimeError):
        cc.load_or_build("zkdsa-test", CFG, _build_zkdsa, cache_dir=str(tmp_path))


@pytest.mark.parametrize("damage", ["payload", "digest", "magic", "truncated"])
def test_corrupted_file_raises(tmp_path, zkdsa, damage):
    path = str(tmp_path / (cc.key_of("zkdsa-test", CFG) + ".ckt"))
    size = cc.write_circuit(path, zkdsa)
    raw = bytearray(open(path, "rb").read())
    assert len(raw) == size
    if damage == "payload":
        raw[-100] ^= 1
    elif damage == "digest":
        raw[len(cc._MAGIC) + 3] ^= 1
    elif damage == "magic":
        raw[0] ^= 1
    else:
        raw = raw[: size // 2]
    open(path, "wb").write(bytes(raw))
    with pytest.raises(cc.CircuitCacheError):
        cc.load_or_build("zkdsa-test", CFG, _build_zkdsa, cache_dir=str(tmp_path), device="cpu")


def test_memo_reads_a_replaced_file_again(tmp_path, zkdsa):
    path = str(tmp_path / (cc.key_of("x", CFG) + ".ckt"))
    cc.write_circuit(path, zkdsa)
    first = cc.load_or_build("x", CFG, _build_zkdsa, cache_dir=str(tmp_path), device="cpu")
    assert cc.load_or_build("x", CFG, _build_zkdsa, cache_dir=str(tmp_path), device="cpu") is first
    # another circuit written over it: same name, other content
    other = SimpleNamespace(tag="replaced", data=pickle.loads(pickle.dumps(zkdsa.data)))
    cc.write_circuit(path, other)
    again = cc.load_or_build("x", CFG, _build_zkdsa, cache_dir=str(tmp_path), device="cpu")
    assert again is not first and again.tag == "replaced"


def test_memo_is_bounded(tmp_path, zkdsa):
    names = [f"c{i}" for i in range(cc.MEMO_MAX + 2)]
    for name in names:
        cc.write_circuit(str(tmp_path / (cc.key_of(name, CFG) + ".ckt")), zkdsa)
        cc.load_or_build(name, CFG, _build_zkdsa, cache_dir=str(tmp_path), device="cpu")
        assert len(cc._MEMO) <= cc.MEMO_MAX
    kept = {os.path.basename(key[0]) for key in cc._MEMO}
    assert kept == {cc.key_of(name, CFG) + ".ckt" for name in names[-cc.MEMO_MAX:]}


def test_block_circuit_name_carries_the_inner_digests():
    def circuit(digest):
        return SimpleNamespace(data=SimpleNamespace(common=SimpleNamespace(circuit_digest=digest)))

    constants = RollupConstants.test_constants()
    user_tx, zkdsa = circuit((1, 2, 3, 4)), circuit((5, 6, 7, 8))
    name = block_circuit_name(constants, True, user_tx, zkdsa)
    assert name == ("block-" + "x".join(str(v) for v in (
        constants.log_max_n_users, constants.log_max_n_txs, constants.log_max_n_contracts,
        constants.log_max_n_variables, constants.log_n_txs, constants.log_n_recipients,
        constants.log_n_contracts, constants.log_n_variables, constants.n_registrations,
        constants.n_diffs, constants.n_merges, constants.n_deposits, constants.n_scroll_flags,
        constants.n_polygon_flags, constants.n_blocks)) + "-rec-0000000000000001-0000000000000005")
    assert block_circuit_name(constants, True, circuit((9, 2, 3, 4)), zkdsa) != name
    assert block_circuit_name(constants, True, user_tx, circuit((6, 6, 7, 8))) != name
    assert block_circuit_name(constants, False, user_tx, zkdsa) != name
    other = CircuitConfig(fri=FriConfig(num_query_rounds=4, proof_of_work_bits=2))
    assert cc.key_of(name, CFG) != cc.key_of(name, other)
    assert np.all([c in cc.key_of(name, CFG) for c in ("-w135", "-r80", "-c2", "-b3", "-h4",
                                                         "-q3", "-p2")])
