"""The port's sparse Merkle tree, dense Merkle tree and their in-circuit
gadgets against the JAX package, on the same seeded keys: the port versions of
``test_smt.py``, ``test_smt_gadgets.py`` and ``test_merkle_gadgets.py``.

Host objects: roots, process and inclusion proofs field by field, their JSON
forms, the layered trees and the storage layout.  Circuits: the port's
builders give the JAX package's circuit digests and generator records, and
the wire matrices of every role of a process proof and of an inclusion and an
exclusion proof equal the JAX package's.  Proofs: one process proof at depth
8 and ``test_config`` proves and verifies on the CPU and its hash equals
``golden/smt_process_8_test.sha256``, made by the JAX package (no JAX proof
is made here); a bad witness is refused; the dense-Merkle gadget proves and
verifies once.  ``test_smt.py::test_user_asset_tree`` has no port version
yet: ``UserAssetTree`` lives in ``models/transaction``, which the port does
not have.
"""

import copy
import hashlib
import json
import pathlib
import random

import numpy as np
import pytest
import torch

from intmax_zkp_core_tpu.engine import prover as jprover
from intmax_zkp_core_tpu.engine.circuit import CircuitBuilder as JBuilder
from intmax_zkp_core_tpu.engine.config import CircuitConfig as JConfig
from intmax_zkp_core_tpu.engine.witness import PartialWitness as JWitness
from intmax_zkp_core_tpu.models import merkle_tree as jmt
from intmax_zkp_core_tpu.models import sparse_merkle_tree as jsmt
from intmax_zkp_core_tpu.models.merkle_tree import gadgets as jmg
from intmax_zkp_core_tpu.models.sparse_merkle_tree import gadgets as jsg
from intmax_zkp_core_tpu.models.sparse_merkle_tree import storage_layout as jsl
from intmax_zkp_core_tpu.utils.hash_out import HashOut as JHash
from intmax_zkp_core_tpu_torch.bin import smt_verifier
from intmax_zkp_core_tpu_torch.bin import verify_smt_process as vsp
from intmax_zkp_core_tpu_torch.engine import prover as tprover
from intmax_zkp_core_tpu_torch.engine.circuit import CircuitBuilder as TBuilder
from intmax_zkp_core_tpu_torch.engine.config import CircuitConfig as TConfig
from intmax_zkp_core_tpu_torch.engine.serde import proof_to_json
from intmax_zkp_core_tpu_torch.engine.witness import PartialWitness as TWitness
from intmax_zkp_core_tpu_torch.models import merkle_tree as tmt
from intmax_zkp_core_tpu_torch.models import sparse_merkle_tree as tsmt
from intmax_zkp_core_tpu_torch.models.merkle_tree import gadgets as tmg
from intmax_zkp_core_tpu_torch.models.sparse_merkle_tree import gadgets as tsg
from intmax_zkp_core_tpu_torch.models.sparse_merkle_tree import storage_layout as tsl
from intmax_zkp_core_tpu_torch.utils.hash_out import HashOut as THash

torch.set_num_threads(1)

P = 0xFFFFFFFF00000001
N_LEVELS = 8
INCLUSION_LEVELS = 8
MERKLE_DEPTH = 4
SEED = 1
GOLDEN = (pathlib.Path(__file__).resolve().parent.parent / "intmax_zkp_core_tpu_torch"
          / "golden" / "smt_process_8_test.sha256")


class Keys:
    """Seeded digests, each made as the port's and the JAX package's HashOut."""

    def __init__(self, seed):
        self.rng = random.Random(seed)

    def __call__(self):
        limbs = tuple(self.rng.randrange(1, 1 << 60) for _ in range(4))
        return THash(limbs), JHash(limbs)


def same(t, j):
    """A port object equals its JAX counterpart: digests by limbs, proofs by
    their JSON form, tuples and lists element-wise."""
    if isinstance(t, (tuple, list)):
        assert len(t) == len(j)
        for a, b in zip(t, j):
            same(a, b)
    elif hasattr(t, "to_json"):
        assert t.to_json() == j.to_json()
    elif isinstance(t, THash):
        assert t.elements == j.elements
    else:
        assert t == j


# --------------------------------------------------------------------------
# host objects
# --------------------------------------------------------------------------


def test_insert_find_get_roundtrip():
    key = Keys(42)
    t, j = tsmt.SparseMerkleTree(), jsmt.SparseMerkleTree()
    entries = []
    for _ in range(12):
        (tk, jk), (tv, jv) = key(), key()
        entries.append((tk, jk, tv))
        p = t.set(tk, tv)
        same(p, j.set(jk, jv))
        assert p.fnc == tsmt.ProcessMerkleProofRole.ProcessInsert
        p.check()
        same(t.get_root(), j.get_root())
    for tk, jk, tv in entries:
        res = t.find(tk)
        same(res, j.find(jk))
        assert res.found and res.value == tv and t.get(tk) == tv
    tk, jk = key()
    same(t.find(tk), j.find(jk))
    assert not t.find(tk).found


def test_update_remove_noop_roles():
    key = Keys(43)
    t, j = tsmt.SparseMerkleTree(), jsmt.SparseMerkleTree()
    (tk, jk), (tv1, jv1), (tv2, jv2) = key(), key(), key()
    roles = []
    for tv, jv in ((tv1, jv1), (tv2, jv2), (THash.ZERO, JHash.ZERO), (THash.ZERO, JHash.ZERO)):
        p = t.set(tk, tv)
        same(p, j.set(jk, jv))
        p.check()
        roles.append(p.fnc.name)
    assert roles == ["ProcessInsert", "ProcessUpdate", "ProcessDelete", "ProcessNoOp"]
    assert t.get(tk) == THash.ZERO


def test_randomized_ops_recheck():
    rng, key = random.Random(44), Keys(45)
    t, j = tsmt.SparseMerkleTree(), jsmt.SparseMerkleTree()
    keys = [key() for _ in range(8)]
    live = set()
    prev = t.get_root()
    for _ in range(60):
        i = rng.randrange(len(keys))
        if i in live and rng.random() < 0.4:
            tv, jv = THash.ZERO, JHash.ZERO
            live.discard(i)
        else:
            tv, jv = key()
            live.add(i)
        p = t.set(keys[i][0], tv)
        same(p, j.set(keys[i][1], jv))
        p.check()
        assert p.old_root == prev
        prev = p.new_root
        assert prev == t.get_root()


def test_change_root_rollback():
    key = Keys(46)
    t, j = tsmt.SparseMerkleTree(), jsmt.SparseMerkleTree()
    (tk1, jk1), (tk2, jk2), (tv1, jv1), (tv2, jv2) = key(), key(), key(), key()
    t.set(tk1, tv1), j.set(jk1, jv1)
    root1 = t.get_root()
    t.set(tk2, tv2), j.set(jk2, jv2)
    t.change_root(root1)
    j.change_root(JHash(root1.elements))
    for tk, jk in ((tk1, jk1), (tk2, jk2)):
        same(t.get(tk), j.get(jk))
    assert t.get(tk1) == tv1 and t.get(tk2) == THash.ZERO
    with pytest.raises(KeyError):
        t.change_root(key()[0])


def test_default_and_tampered_process_proofs():
    key = Keys(47)
    tr, jr = key()
    p = tsmt.SparseMerkleProcessProof.with_root(tr)
    same(p, jsmt.SparseMerkleProcessProof.with_root(jr))
    p.check()
    t = tsmt.SparseMerkleTree()
    t.set(key()[0], key()[0])
    p = t.set(key()[0], key()[0])
    bad = tsmt.SparseMerkleProcessProof(**{**p.__dict__})
    bad.new_value = key()[0]
    with pytest.raises(AssertionError):
        bad.check()
    with pytest.raises(AssertionError):
        jsmt.SparseMerkleProcessProof.from_json(bad.to_json()).check()


def test_proof_json_round_trip():
    key = Keys(48)
    t, j = tsmt.SparseMerkleTree(), jsmt.SparseMerkleTree()
    for _ in range(3):
        (tk, jk), (tv, jv) = key(), key()
        p = t.set(tk, tv)
        j.set(jk, jv)
    for obj, cls, jcls in (
        (p, tsmt.SparseMerkleProcessProof, jsmt.SparseMerkleProcessProof),
        (t.find(tk), tsmt.SparseMerkleInclusionProof, jsmt.SparseMerkleInclusionProof),
    ):
        text = json.dumps(obj.to_json())
        assert cls.from_json(json.loads(text)) == obj
        assert jcls.from_json(json.loads(text)).to_json() == obj.to_json()


def test_layered_trees():
    key = Keys(49)
    t, j = tsmt.LayeredSparseMerkleTree(), jsmt.LayeredSparseMerkleTree()
    (tk1, jk1), (tk2, jk2), (tv, jv) = key(), key(), key()
    for value in ((tv, jv), (THash.ZERO, JHash.ZERO)):
        ps_ = t.set(tk1, tk2, value[0])
        same(ps_, j.set(jk1, jk2, value[1]))
        for p in ps_:
            p.check()
        p1, p2 = ps_
        tsmt.verify_layered_smt_connection(p1.fnc, p1.old_value, p1.new_value, p2.old_root,
                                           p2.new_root)
        same(t.get_root(), j.get_root())
    assert p1.fnc == tsmt.ProcessMerkleProofRole.ProcessDelete
    t3, j3 = tsmt.LayeredLayeredSparseMerkleTree(), jsmt.LayeredLayeredSparseMerkleTree()
    ks = [key() for _ in range(3)]
    ps_ = t3.set(*(k[0] for k in ks), tv)
    same(ps_, j3.set(*(k[1] for k in ks), jv))
    for a, b in zip(ps_, ps_[1:]):
        tsmt.verify_layered_smt_connection(a.fnc, a.old_value, a.new_value, b.old_root, b.new_root)
    res = t3.find(*(k[0] for k in ks))
    same(res, j3.find(*(k[1] for k in ks)))
    assert res[-1].found and res[-1].value == tv


def test_storage_layout():
    key = Keys(50)
    tpos, jpos = key()
    for index in (0, 1, 7):
        same(tsl.get_index_position(tpos, index), jsl.get_index_position(jpos, index))
    (tk, jk), (tv, jv) = key(), key()
    same(tsl.get_key_position(tpos, tk), jsl.get_key_position(jpos, jk))
    tc, jc = key()
    lt = tsl.StorageLayout(tsmt.LayeredSparseMerkleTree(), prefix=(tc,))
    lj = jsl.StorageLayout(jsmt.LayeredSparseMerkleTree(), prefix=(jc,))
    data = bytes(range(37))
    for name, targs, jargs in (
        ("write_u128", (tpos, 123456789), (jpos, 123456789)),
        ("push_vector_value", (tk, tv), (jk, jv)),
        ("write_mapping_value", (tk, tpos, tv), (jk, jpos, jv)),
        ("write_bytes_data", (tv, data), (jv, data)),
    ):
        same(getattr(lt, name)(*targs), getattr(lj, name)(*jargs))
    same(lt.tree.get_root(), lj.tree.get_root())
    assert lt.read_u128(tpos)[0] == 123456789
    assert lt.read_vector_value(tk, 0)[0] == tv
    assert lt.read_mapping_value(tk, tpos)[0] == tv
    assert lt.read_bytes_data(tv)[0] == data
    same(lt.read_bytes_data(tv)[1], lj.read_bytes_data(jv)[1])


def test_dense_merkle_tree():
    leaves = [(THash.from_u32(100 + i), JHash.from_u32(100 + i)) for i in range(5)]
    for index in (0, 3, 4):
        p = tmt.get_merkle_proof_with_zero([t for t, _ in leaves], index, MERKLE_DEPTH, THash.ZERO)
        q = jmt.get_merkle_proof_with_zero([j for _, j in leaves], index, MERKLE_DEPTH, JHash.ZERO)
        assert p.to_json() == q.to_json()
        assert tmt.get_merkle_root(p.index, p.value, p.siblings) == p.root
    with pytest.raises(AssertionError):
        tmt.get_merkle_proof_with_zero([t for t, _ in leaves], 11, MERKLE_DEPTH, THash.ZERO)
    with pytest.raises(AssertionError):
        tmt.get_merkle_proof_with_zero([t for t, _ in leaves] * 2, 5, 2, THash.ZERO)


def test_smt_verifier_loop():
    proofs = smt_verifier.main(20, seed=SEED, device="cpu")
    assert {p.fnc.name for p in proofs} >= {"ProcessInsert", "ProcessUpdate"}


@pytest.mark.parametrize("n_levels", [8, 256])
def test_verify_smt_process_runs_the_reference_mix(n_levels):
    """``verify_smt_process.main`` runs the reference loop's mix: random keys
    below 2^min(n_levels - 1, 30) set to random values, so that each step
    inserts or, on a repeated key, updates.  The same seed gives the same
    steps, and the port's and the JAX package's trees agree on each."""
    ops = vsp.operations(40, n_levels, SEED)
    assert ops == vsp.operations(40, n_levels, SEED)
    t, j = tsmt.SparseMerkleTree(), jsmt.SparseMerkleTree()
    seen = set()
    for key, value in ops:
        assert 0 <= key < 1 << min(n_levels - 1, 30)
        tp = t.set(THash.from_u32(key), THash(value))
        same(tp, j.set(JHash.from_u32(key), JHash(value)))
        assert tp.fnc.name == ("ProcessUpdate" if key in seen else "ProcessInsert")
        seen.add(key)
    assert (len(seen) < len(ops)) == (n_levels == 8)  # 2^7 keys repeat in 40 draws


# --------------------------------------------------------------------------
# circuits
# --------------------------------------------------------------------------


def _process(builder_cls, config, gadgets, hash_cls, **kw):
    b = builder_cls(config, **kw)
    target = gadgets.SparseMerkleProcessProofTarget.add_virtual_to(b, N_LEVELS)
    b.register_public_inputs(list(target.old_root))
    b.register_public_inputs(list(target.new_root))
    return b, target


def _inclusion(builder_cls, config, gadgets, hash_cls, **kw):
    b = builder_cls(config, **kw)
    target = gadgets.SparseMerkleInclusionProofTarget.add_virtual_to(b, INCLUSION_LEVELS)
    b.register_public_inputs(list(target.root))
    return b, target


def _merkle(builder_cls, config, gadgets, hash_cls, **kw):
    """The dense-Merkle gadgets in one circuit: a proof of depth
    ``MERKLE_DEPTH`` and the root of eight constant leaves, both roots public."""
    b = builder_cls(config, **kw)
    target = gadgets.MerkleProofTarget.add_virtual_to(b, MERKLE_DEPTH)
    leaves = [b.constant_hash(hash_cls.from_u32(100 + i)) for i in range(8)]
    b.register_public_inputs(list(target.root))
    b.register_public_inputs(list(gadgets.get_merkle_root_target_from_leaves(b, leaves)))
    return b, target


CIRCUITS = {"process": (_process, tsg, jsg), "inclusion": (_inclusion, tsg, jsg),
            "merkle": (_merkle, tmg, jmg)}
# what a builder holds before build(): the whole circuit as records
BUILDER_STATE = ("rows", "generators", "parent", "targets_at_place", "preset_values",
                 "public_input_targets")


def _state(builder):
    state = {k: copy.deepcopy(getattr(builder, k)) for k in BUILDER_STATE}
    state["rows"] = [(g, list(c)) for g, c in state["rows"]]
    state["generators"] = [tuple(r) for r in state["generators"]]
    return state


@pytest.fixture(scope="module")
def circuits():
    """Each circuit from the port's builder, built on the CPU, beside the JAX
    package's builder holding the same gadgets.  The JAX package builds only
    the smallest (its build compiles for seconds at each circuit height); the
    process circuit's digest is held against the one its golden file records,
    made by the JAX package's build, and the inclusion circuit by its records."""
    out = {}
    for name, (make, tg, jg) in CIRCUITS.items():
        b, target = make(TBuilder, TConfig.test_config(), tg, THash, device="cpu")
        jb, jtarget = make(JBuilder, JConfig.test_config(), jg, JHash)
        state, jstate = _state(b), _state(jb)
        out[name] = {"data": b.build(), "target": target, "jtarget": jtarget,
                     "state": state, "jstate": jstate,
                     "jdata": jb.build() if name == "merkle" else None}
    return out


@pytest.mark.parametrize("name", list(CIRCUITS))
def test_circuit_records_equal_jax(circuits, name):
    c = circuits[name]
    for k in BUILDER_STATE:
        assert c["state"][k] == c["jstate"][k], k


@pytest.mark.parametrize("name", ["process", "merkle"])
def test_circuit_digests_equal_jax(circuits, name):
    t = circuits[name]["data"]
    if name == "process":
        assert t.common.n == 256
        assert tuple(t.common.circuit_digest) == golden_digest(GOLDEN)
        return
    j = circuits[name]["jdata"]
    assert t.common.n == j.common.n
    assert tuple(t.common.circuit_digest) == tuple(j.common.circuit_digest)
    assert list(t.common.constants_sigmas_cap) == list(j.common.constants_sigmas_cap)
    assert (t.prover.constants_sigmas == np.asarray(j.prover.constants_sigmas)).all()


def golden_digest(path):
    """The JAX package's circuit digest, the second line of a golden file."""
    tag, *limbs = path.read_text().splitlines()[1].split()[:5]
    assert tag == "circuit_digest"
    return tuple(int(x) for x in limbs)


def _wires_equal(c, t_pw, j_pw):
    """The port's native fill against the JAX package's compute_wire_matrix
    on the same circuit (a copy of the port's prover data, so that the JAX
    fill plan is cached on the copy), each with its own package's witness."""
    pd = c["data"].prover
    tw, tpi = tprover.compute_wire_matrix(pd, t_pw)
    view = copy.copy(pd)
    view.__dict__.pop("_fill_plan", None)
    jw, jpi = jprover.compute_wire_matrix(view, j_pw)
    assert (tw == np.asarray(jw)).all()
    assert [int(v) for v in tpi] == [int(v) for v in jpi]
    return tpi


@pytest.fixture(scope="module")
def process_steps():
    """The five steps of the binary's ``role_cycle``: every role, each with the
    port's and the JAX package's process proof."""
    t, j = tsmt.SparseMerkleTree(), jsmt.SparseMerkleTree()
    steps = []
    for key, value in vsp.role_cycle(5, N_LEVELS, SEED):
        steps.append((t.set(THash.from_u32(key), THash(value)),
                      j.set(JHash.from_u32(key), JHash(value))))
    return steps


@pytest.mark.parametrize("step", range(5))
def test_process_wire_matrix_every_role(circuits, process_steps, step):
    c = circuits["process"]
    tp, jp = process_steps[step]
    same(tp, jp)
    assert tp.fnc.name == ("ProcessInsert", "ProcessInsert", "ProcessUpdate", "ProcessDelete",
                           "ProcessNoOp")[step]
    if step < 2:  # into the empty tree, then beside its one leaf
        assert tp.is_old0 == (step == 0)
    t_pw, j_pw = TWitness(), JWitness()
    c["target"].set_witness(t_pw, tp)
    c["jtarget"].set_witness(j_pw, jp)
    pi = _wires_equal(c, t_pw, j_pw)
    assert pi == list(tp.old_root.elements) + list(tp.new_root.elements)


def test_process_proof_equals_golden_and_verifies(circuits, process_steps):
    data, target = circuits["process"]["data"], circuits["process"]["target"]
    pw = TWitness()
    target.set_witness(pw, process_steps[0][0])
    proof = data.prove(pw)
    digest = hashlib.sha256(json.dumps(proof_to_json(proof), sort_keys=True).encode()).hexdigest()
    assert digest == GOLDEN.read_text().split()[0]
    data.verify(proof)
    bad = copy.deepcopy(proof)
    bad.public_inputs[4] = (bad.public_inputs[4] + 1) % P
    with pytest.raises(AssertionError):
        data.verify(bad)


def test_process_gadget_refuses_a_bad_witness(circuits, process_steps):
    data, target = circuits["process"]["data"], circuits["process"]["target"]
    bad = copy.deepcopy(process_steps[1][0])
    bad.new_value = THash.from_u32(999)  # inconsistent with new_root
    pw = TWitness()
    target.set_witness(pw, bad)
    with pytest.raises(AssertionError):
        data.prove(pw)


@pytest.mark.parametrize("found", [True, False], ids=["inclusion", "exclusion"])
def test_inclusion_wire_matrix(circuits, found):
    c = circuits["inclusion"]
    t, j = tsmt.SparseMerkleTree(), jsmt.SparseMerkleTree()
    for i in (1, 2, 6):
        t.set(THash.from_u32(i), THash.from_u32(10 * i))
        j.set(JHash.from_u32(i), JHash.from_u32(10 * i))
    k = 2 if found else 5
    tp, jp = t.find(THash.from_u32(k)), j.find(JHash.from_u32(k))
    same(tp, jp)
    assert tp.found == found
    t_pw, j_pw = TWitness(), JWitness()
    c["target"].set_witness(t_pw, tp, True)
    c["jtarget"].set_witness(j_pw, jp, True)
    assert _wires_equal(c, t_pw, j_pw) == list(t.get_root().elements)


def test_merkle_gadgets_prove_and_verify(circuits):
    """In-circuit root from a proof at several indices of a partly filled
    tree, and from all eight leaves (a full layer, where the gadget's
    duplication of odd tails and the tree's zero padding agree)."""
    c = circuits["merkle"]
    leaves = [(THash.from_u32(100 + i), JHash.from_u32(100 + i)) for i in range(8)]
    all_leaves_root = tmt.get_merkle_proof_with_zero([t for t, _ in leaves], 0, 3, THash.ZERO).root
    for index in (0, 3, 4):
        p = tmt.get_merkle_proof_with_zero([t for t, _ in leaves[:5]], index, MERKLE_DEPTH,
                                           THash.ZERO)
        q = jmt.get_merkle_proof_with_zero([j for _, j in leaves[:5]], index, MERKLE_DEPTH,
                                           JHash.ZERO)
        t_pw, j_pw = TWitness(), JWitness()
        assert c["target"].set_witness(t_pw, p.index, p.value, p.siblings) == p.root
        c["jtarget"].set_witness(j_pw, q.index, q.value, q.siblings)
        pi = _wires_equal(c, t_pw, j_pw)
        assert pi == list(p.root.elements) + list(all_leaves_root.elements)
    proof = c["data"].prove(t_pw)
    c["data"].verify(proof)
    assert proof.public_inputs == pi
