"""The port's user-transaction layer against the JAX package: the port
version of ``test_user_transaction.py`` (and of
``test_smt.py::test_user_asset_tree``).

Host objects, from the same seeded inputs on both sides: the
``UserAssetTree`` roots, process and inclusion proofs, ``get_block_hash`` and
the block-header tree proof, ``MergeAndPurgeTransitionPublicInputs`` encode /
decode and its default ``tx_hash``.  The circuit at the JAX test's
``small_constants()`` and ``FriConfig(4, 2)``: the port's builder holds the
JAX builder's records before ``build()`` (rows, generators, copy classes,
presets, public inputs), and its digest is the one
``golden/user_tx_small_test.sha256`` records from the JAX build.  The proof:
the purge-only transition proved on the CPU by ``prove_batch`` at K = 1
(which ``prove`` is); its hash equals the JAX package's sequential proof of
the same witness (the golden's first line), its public inputs are those the
JAX test checks, it verifies, a tampered copy is refused.  The default
transaction's witness satisfies the circuit and gives the default public
inputs.  The port's witnesses equal the JAX package's wire matrices.
Batches of K > 1 are held against sequential proofs by
``test_torch_batch_prover.py`` (arithmetic and zkDSA circuits) and, for
this circuit at the flagship's constants, on the card
(``test_torch_cuda.py``, ``chip_smoke.py``).  Tolerance 0.

The JAX package builds no circuit and makes no proof here, and the port
makes one: a 2,048-row proof costs about 20 s on one CPU thread in either
package.
"""

import copy
import hashlib
import json
import pathlib
import random

import numpy as np
import pytest
import torch

from intmax_zkp_core_tpu.config import RollupConstants as JConstants
from intmax_zkp_core_tpu.engine import prover as jprover
from intmax_zkp_core_tpu.engine.circuit import CircuitBuilder as JBuilder
from intmax_zkp_core_tpu.engine.config import CircuitConfig as JConfig, FriConfig as JFri
from intmax_zkp_core_tpu.engine.witness import PartialWitness as JWitness
from intmax_zkp_core_tpu.models import sparse_merkle_tree as jsmt
from intmax_zkp_core_tpu.models.transaction import block_header as jbh
from intmax_zkp_core_tpu.models.transaction import circuits as jtc
from intmax_zkp_core_tpu.models.transaction.user_asset_tree import UserAssetTree as JUserAssetTree
from intmax_zkp_core_tpu.models.zkdsa.account import Address as JAddress
from intmax_zkp_core_tpu.utils.hash_out import HashOut as JHash
from intmax_zkp_core_tpu_torch.config import RollupConstants as TConstants
from intmax_zkp_core_tpu_torch.engine import circuit as tcircuit
from intmax_zkp_core_tpu_torch.engine import prover as tprover
from intmax_zkp_core_tpu_torch.engine.batch_prover import prove_batch
from intmax_zkp_core_tpu_torch.engine.config import CircuitConfig as TConfig, FriConfig as TFri
from intmax_zkp_core_tpu_torch.engine.serde import proof_to_json
from intmax_zkp_core_tpu_torch.engine.witness import PartialWitness as TWitness
from intmax_zkp_core_tpu_torch.models import sparse_merkle_tree as tsmt
from intmax_zkp_core_tpu_torch.models.rollup import block_flow as tflow
from intmax_zkp_core_tpu_torch.models.transaction import block_header as tbh
from intmax_zkp_core_tpu_torch.models.transaction import circuits as ttc
from intmax_zkp_core_tpu_torch.models.transaction.user_asset_tree import UserAssetTree as TUserAssetTree
from intmax_zkp_core_tpu_torch.models.zkdsa.account import Address as TAddress
from intmax_zkp_core_tpu_torch.utils.hash_out import HashOut as THash
from intmax_zkp_core_tpu_torch.utils.poseidon_host import two_to_one as t_two_to_one

torch.set_num_threads(1)

P = 0xFFFFFFFF00000001
GOLDEN = (pathlib.Path(__file__).resolve().parent.parent / "intmax_zkp_core_tpu_torch"
          / "golden" / "user_tx_small_test.sha256")
SMALL = dict(  # tests/test_user_transaction.py::small_constants
    log_max_n_users=3, log_max_n_txs=3, log_max_n_contracts=3, log_max_n_variables=3,
    log_n_txs=2, log_n_recipients=3, log_n_contracts=3, log_n_variables=3, n_registrations=1,
    n_diffs=1, n_merges=1, n_deposits=1, n_scroll_flags=1, n_polygon_flags=1, n_blocks=2,
)


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


def test_user_asset_tree():
    # test_smt.py::test_user_asset_tree, both packages on the same keys
    key = Keys(61)
    t, j = TUserAssetTree(), JUserAssetTree()
    (tmk, jmk), (tca, jca), (tvi, jvi) = key(), key(), key()
    res = t.set(tmk, tca, tvi, THash.from_u32(100))
    same(res, j.set(jmk, jca, jvi, JHash.from_u32(100)))
    for p in res:
        p.check()
    found = t.find(tmk, tca, tvi)
    same(found, j.find(jmk, jca, jvi))
    assert all(r.found for r in found) and found[2].value == THash.from_u32(100)
    asset_root = t.get_asset_root(tmk)
    assert asset_root == found[1].root
    same(asset_root, j.get_asset_root(jmk))
    (tvi2, jvi2), (tother, jother) = key(), key()
    same(t.set(tmk, tca, tvi2, THash.from_u32(7)), j.set(jmk, jca, jvi2, JHash.from_u32(7)))
    assert t.get_asset_root(tmk) != asset_root
    assert t.get_asset_root(tother) == THash.ZERO
    same(t.get_root(), j.get_root())


def test_user_asset_tree_seeded_operations():
    # insert, update and delete under three merge keys; every layer's process
    # proof and every root equal, and the tree refuses an unknown root
    rng, key = random.Random(62), Keys(63)
    t, j = TUserAssetTree(), JUserAssetTree()
    slots = [(key(), key(), key()) for _ in range(6)]
    for step in range(24):
        (tmk, jmk), (tca, jca), (tvi, jvi) = slots[rng.randrange(len(slots))]
        amount = 0 if step % 5 == 4 else rng.randrange(1, 1 << 40)
        res = t.set(tmk, tca, tvi, THash.from_u32(amount) if amount < 1 << 32 else THash((amount, 0, 0, 0)))
        same(res, j.set(jmk, jca, jvi, JHash.from_u32(amount) if amount < 1 << 32
                        else JHash((amount, 0, 0, 0))))
        same(t.get_root(), j.get_root())
        same(t.find(tmk, tca, tvi), j.find(jmk, jca, jvi))
    with pytest.raises(KeyError):
        t.change_root(THash.from_u32(12345))


def _header(cls, hash_cls, limbs):
    return cls(block_number=7, prev_block_hash=hash_cls(limbs[0]),
               block_headers_digest=hash_cls(limbs[1]), transactions_digest=hash_cls(limbs[2]),
               deposit_digest=hash_cls(limbs[3]), proposed_world_state_digest=hash_cls(limbs[4]),
               approved_world_state_digest=hash_cls(limbs[5]),
               latest_account_digest=hash_cls(limbs[6]))


def test_block_header_and_block_hash():
    rng = random.Random(64)
    limbs = [tuple(rng.randrange(P) for _ in range(4)) for _ in range(7)]
    th, jh = _header(tbh.BlockHeader, THash, limbs), _header(jbh.BlockHeader, JHash, limbs)
    assert th.to_json() == jh.to_json()
    assert tbh.BlockHeader.from_json(th.to_json()) == th
    same(tbh.get_block_hash(th), jbh.get_block_hash(jh))
    for log_n in (1, 2, 3):
        assert tbh.BlockHeader.new(log_n).to_json() == jbh.BlockHeader.new(log_n).to_json()
    # the first block's append path into the empty block-header tree
    got = tbh.get_block_header_tree_proof([], tbh.get_block_hash(th), 5)
    want = jbh.get_block_header_tree_proof([], jbh.get_block_hash(jh), 5)
    same(list(got[0]), list(want[0]))
    same(got[1:], want[1:])


def test_default_user_transaction_public_inputs():
    # circuits/mod.rs:203-247: default tx_hash = Poseidon(0 || 0)
    d = ttc.MergeAndPurgeTransitionPublicInputs.default()
    assert d.tx_hash == t_two_to_one(THash.ZERO, THash.ZERO)
    assert ttc.MergeAndPurgeTransitionPublicInputs.decode(d.encode()) == d
    assert d.encode() == jtc.MergeAndPurgeTransitionPublicInputs.default().encode()


def test_public_inputs_encode_decode_equal_jax():
    rng = random.Random(65)
    roots = [tuple(rng.randrange(P) for _ in range(4)) for _ in range(5)]
    kw = lambda cls, hash_cls, addr: dict(  # noqa: E731
        sender_address=addr(987654321), old_user_asset_root=hash_cls(roots[0]),
        middle_user_asset_root=hash_cls(roots[1]), new_user_asset_root=hash_cls(roots[2]),
        diff_root=hash_cls(roots[3]), tx_hash=hash_cls(roots[4]))
    t = ttc.MergeAndPurgeTransitionPublicInputs(**kw(None, THash, TAddress))
    j = jtc.MergeAndPurgeTransitionPublicInputs(**kw(None, JHash, JAddress))
    assert t.encode() == j.encode() and len(t.encode()) == 24
    assert ttc.MergeAndPurgeTransitionPublicInputs.decode(j.encode()) == t


# --------------------------------------------------------------------------
# the circuit and its proofs
# --------------------------------------------------------------------------

BUILDER_STATE = ("rows", "generators", "parent", "targets_at_place", "preset_values",
                 "public_input_targets")


def _state(builder):
    state = {k: copy.deepcopy(getattr(builder, k)) for k in BUILDER_STATE}
    state["rows"] = [(g, list(c)) for g, c in state["rows"]]
    state["generators"] = [tuple(r) for r in state["generators"]]
    return state


def _jax_circuit():
    """The JAX package's builder state for the same circuit, taken at its
    ``build()``, which is not run (it compiles for seconds on a CPU), and its
    targets (the circuit's ``data`` is None)."""
    held = {}

    def build(self):
        held["state"] = _state(self)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(JBuilder, "build", build)
        c = jtc.make_user_proof_circuit(
            JConstants(**SMALL), JConfig(fri=JFri(num_query_rounds=4, proof_of_work_bits=2)))
    return held["state"], c.targets


@pytest.fixture(scope="module")
def circuit():
    """The port's circuit at small_constants, built on the CPU, with its
    builder's records and the JAX builder's."""
    held = {}
    build = tcircuit.CircuitBuilder.build

    def recording(self):
        held["state"] = _state(self)
        return build(self)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tcircuit.CircuitBuilder, "build", recording)
        c = ttc.make_user_proof_circuit(
            TConstants(**SMALL), TConfig(fri=TFri(num_query_rounds=4, proof_of_work_bits=2)),
            device="cpu")
    jstate, jtargets = _jax_circuit()
    return {"circuit": c, "state": held["state"], "jstate": jstate, "jtargets": jtargets}


def golden():
    """(purge proof hash, circuit digest, default proof hash) of the JAX package."""
    lines = GOLDEN.read_text().splitlines()
    tag, *limbs = lines[1].split()[:5]
    assert tag == "circuit_digest"
    return lines[0].split()[0], tuple(int(x) for x in limbs), lines[2].split()[0]


def test_circuit_records_equal_jax(circuit):
    for k in BUILDER_STATE:
        assert circuit["state"][k] == circuit["jstate"][k], k


def test_circuit_digest_equals_jax(circuit):
    common = circuit["circuit"].data.common
    assert common.n == 2048
    assert tuple(common.gate_ids) == ("arithmetic", "constant", "noop", "poseidon", "public_input")
    assert tuple(common.circuit_digest) == golden()[1]
    # the SMT gadgets register no generator kind of their own
    kinds = {rec[0] for rec in circuit["circuit"].data.prover.generators}
    assert kinds <= {"arith", "poseidon", "split_le", "inv_or_zero"}


def purge_only(hash_cls, tree_cls, diff_cls, tc, address):
    """The transition of ``test_user_transaction_purge_only`` in one package,
    with the roots the JAX test checks."""
    merge_key, contract, variable = hash_cls.from_u32(1), hash_cls.from_u32(3), hash_cls.from_u32(5)
    amount, recipient = hash_cls.from_u32(10), hash_cls.from_u32(2)
    user_tree = tree_cls()
    user_tree.set(merge_key, contract, variable, amount)
    old_root = user_tree.get_root()
    purge_input = [user_tree.set(merge_key, contract, variable, hash_cls.ZERO)]
    diff_tree = diff_cls()
    purge_output = [diff_tree.set(recipient, contract, variable, amount)]
    transition = tc.MergeAndPurgeTransition(
        sender_address=address(777), merge_witnesses=[], purge_input_witnesses=purge_input,
        purge_output_witnesses=purge_output, nonce=hash_cls.from_u32(99),
        old_user_asset_root=old_root)
    return transition, {"old": old_root, "new": user_tree.get_root(),
                        "diff": diff_tree.get_root()}


@pytest.fixture(scope="module")
def witnesses(circuit):
    """The purge-only and the default transaction's witnesses, in both
    packages, with the public inputs each must give."""
    c = circuit["circuit"]
    transition, roots = purge_only(THash, TUserAssetTree, tsmt.LayeredLayeredSparseMerkleTree,
                                   ttc, TAddress)
    jtransition, _ = purge_only(JHash, JUserAssetTree, jsmt.LayeredLayeredSparseMerkleTree,
                                jtc, JAddress)
    purge_pw, expected = c.witness(transition)
    j_purge, jtargets = JWitness(), circuit["jtargets"]
    j_expected = jtargets.set_witness(
        j_purge, jtransition.sender_address, jtransition.merge_witnesses,
        jtransition.purge_input_witnesses, jtransition.purge_output_witnesses, jtransition.nonce,
        jtransition.old_user_asset_root)
    assert expected.encode() == j_expected.encode()
    default_pw = TWitness()
    default_expected = c.targets.set_witness(default_pw, TAddress(0), [], [], [], THash.ZERO,
                                             THash.ZERO)
    j_default = JWitness()
    jtargets.set_witness(j_default, JAddress(0), [], [], [], JHash.ZERO, JHash.ZERO)
    return {"pws": [purge_pw, default_pw], "jpws": [j_purge, j_default],
            "expected": [expected, default_expected], "roots": roots}


@pytest.mark.parametrize("which", [0, 1], ids=["purge", "default"])
def test_witness_equals_jax_wire_matrix(circuit, witnesses, which):
    # the port's native fill against the JAX package's compute_wire_matrix on
    # a copy of the port's prover data, each with its own package's witness
    pd = circuit["circuit"].data.prover
    tw, tpi = tprover.compute_wire_matrix(pd, witnesses["pws"][which])
    view = copy.copy(pd)
    view.__dict__.pop("_fill_plan", None)
    jw, jpi = jprover.compute_wire_matrix(view, witnesses["jpws"][which])
    assert (tw == np.asarray(jw)).all()
    assert [int(v) for v in tpi] == [int(v) for v in jpi]
    assert tpi == witnesses["expected"][which].encode()


@pytest.fixture(scope="module")
def batch(circuit, witnesses):
    """``prove_batch`` of the purge-only transition alone (K = 1)."""
    return prove_batch(circuit["circuit"].data, witnesses["pws"][:1])


def proof_sha256(proof):
    return hashlib.sha256(json.dumps(proof_to_json(proof), sort_keys=True).encode()).hexdigest()


@pytest.mark.parametrize("which", [0], ids=["purge"])
def test_batch_proofs_equal_the_jax_sequential_proofs(batch, which):
    # the golden's first line: the JAX package's prove of the purge witness
    assert proof_sha256(batch[which]) == golden()[which]


def test_purge_only_public_inputs_and_verify(circuit, witnesses, batch):
    # test_user_transaction_purge_only's checks, on the purge proof
    c, roots = circuit["circuit"], witnesses["roots"]
    proof = batch[0]
    pis = c.public_inputs(proof)
    assert pis == witnesses["expected"][0]
    assert pis.sender_address == TAddress(777)
    assert pis.old_user_asset_root == roots["old"]
    assert pis.middle_user_asset_root == roots["old"]  # no merges
    assert pis.new_user_asset_root == roots["new"]
    assert pis.diff_root == roots["diff"]
    assert pis.tx_hash == t_two_to_one(roots["diff"], THash.from_u32(99))
    c.verify(proof)
    bad = copy.deepcopy(proof)
    bad.public_inputs[20] = (bad.public_inputs[20] + 1) % P
    with pytest.raises(AssertionError):
        c.verify(bad)


def test_default_transaction_witness_satisfies_the_circuit(circuit, witnesses):
    # every constraint holds on the default transaction's witness, and its
    # public inputs are the default ones
    pis = circuit["circuit"].data.check_witness(witnesses["pws"][1])
    assert pis == witnesses["expected"][1].encode()
    assert witnesses["expected"][1] == ttc.MergeAndPurgeTransitionPublicInputs.default()


def test_circuit_refuses_a_bad_witness(circuit, witnesses):
    # a purge whose output root is not the one its proofs lead to
    pw = TWitness()
    pw.values.update(witnesses["pws"][0].values)
    target = list(circuit["circuit"].targets.purge_proof_target.diff_root)[0]
    pw.values[target] = (pw.values.get(target, 0) + 1) % P
    with pytest.raises(AssertionError):
        circuit["circuit"].data.check_witness(pw)


def test_entry_points_raise_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError):
        ttc.make_user_proof_circuit(TConstants(**SMALL))
    with pytest.raises(RuntimeError):
        tflow.prove_user_txs_and_signatures(TConstants(**SMALL))
