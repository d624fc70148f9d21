"""The port's rollup layer (``models/rollup/``, ``models/transaction/asset.py``)
against the JAX package.

Host objects, from the same seeded inputs on both sides: ``VariableIndex``,
``DepositInfo``, the asset types, ``make_deposit_proof``,
``BlockProductionPublicInputs`` (encode, decode, JSON, entry hash) and
``BlockInfo`` read from and written back to ``test_cases/block1_info.json``.

The block circuit's four gadgets (deposit, proposal, approval, block-headers
tree), each alone in a circuit at ``MINI`` / ``MINI_CFG``
(``tests/rollup_gadget_circuits.py``): the port's builder holds the JAX
builder's records before ``build()``, the port's digest and rows are the JAX
build's (``golden/rollup_gadgets_mini.sha256``, made by
``experiments/make_block_goldens.py gadgets``), and on one seeded witness
the port's ``check_witness`` gives the public inputs the witness stands for,
which the JAX package's witness fill gives too.

The flow: the port's ``run_block_flow(prove=False)`` on the CPU gives the
``BlockInfo`` of ``test_cases/block1_info.json`` and the entry hash the JAX
package's check mode gives, with the JAX test's checks
(``tests/test_block_flow.py``).  On its user-transaction and zkDSA circuits,
the recursive block circuit at ``test_constants`` (the inner proofs verified
in the circuit) has the JAX builder's records before ``build()`` (by their
hash, ``golden/block_records_standard.sha256``); its 65,536-row build costs
minutes on a CPU, so its digest is held against
``golden/block_flow_standard.sha256`` on the card (``test_torch_cuda.py``,
``chip_smoke.py``).
Tolerance 0.
"""

import copy
import json
import pathlib
import random
import sys
from types import SimpleNamespace

import pytest
import torch

from intmax_zkp_core_tpu.engine import prover as jprover
from intmax_zkp_core_tpu.engine.circuit import CircuitBuilder as JBuilder
from intmax_zkp_core_tpu.engine.witness import PartialWitness as JWitness
from intmax_zkp_core_tpu.models.rollup import address_list as jal
from intmax_zkp_core_tpu.models.rollup import block as jblock
from intmax_zkp_core_tpu.models.rollup import circuits as jrc
from intmax_zkp_core_tpu.models.rollup import deposit as jdep
from intmax_zkp_core_tpu.models.rollup.gadgets import deposit_block as jdb
from intmax_zkp_core_tpu.models.transaction import asset as jasset
from intmax_zkp_core_tpu.models.zkdsa.account import Address as JAddress
from intmax_zkp_core_tpu.utils.hash_out import HashOut as JHash
from intmax_zkp_core_tpu_torch.config import RollupConstants as TConstants
from intmax_zkp_core_tpu_torch.engine import circuit as tcircuit
from intmax_zkp_core_tpu_torch.engine.witness import PartialWitness as TWitness
from intmax_zkp_core_tpu_torch.models.rollup import address_list as tal
from intmax_zkp_core_tpu_torch.models.rollup import block as tblock
from intmax_zkp_core_tpu_torch.models.rollup import block_flow as tflow
from intmax_zkp_core_tpu_torch.models.rollup import circuits as trc
from intmax_zkp_core_tpu_torch.models.rollup import deposit as tdep
from intmax_zkp_core_tpu_torch.models.rollup.gadgets import deposit_block as tdb
from intmax_zkp_core_tpu_torch.models.transaction import asset as tasset
from intmax_zkp_core_tpu_torch.models.transaction.gadgets.merge import MergeProof
from intmax_zkp_core_tpu_torch.models.zkdsa.account import Address as TAddress
from intmax_zkp_core_tpu_torch.utils.hash_out import HashOut as THash

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent))
import rollup_gadget_circuits as rg  # noqa: E402

P = 0xFFFFFFFF00000001
ROOT = pathlib.Path(__file__).resolve().parent.parent
GOLDEN = ROOT / "intmax_zkp_core_tpu_torch" / "golden"
BLOCK1_INFO = ROOT / "test_cases" / "block1_info.json"
ENTRY_HASH = (9738196181870042524, 11696639860342013396, 1907484470672876494,
              3974110925381116255)
BUILDER_STATE = ("rows", "generators", "parent", "targets_at_place", "preset_values",
                 "public_input_targets")


def _state(builder):
    """The builder's records as they stand (its ``build()`` goes on to add
    to them): each container copied one level down, where ``build()`` writes."""
    return {"rows": [(g, list(c)) for g, c in builder.rows],
            "generators": [tuple(r) for r in builder.generators],
            "parent": list(builder.parent),
            "targets_at_place": dict(builder.targets_at_place),
            "preset_values": dict(builder.preset_values),
            "public_input_targets": list(builder.public_input_targets)}


# --------------------------------------------------------------------------
# host objects
# --------------------------------------------------------------------------


def _deposits(rng, address, variable_index, info):
    return [info(receiver_address=address(rng.randrange(1 << 40)),
                 contract_address=address(rng.randrange(1 << 40)),
                 variable_index=variable_index(rng.randrange(256)),
                 amount=rng.randrange(1 << 60)) for _ in range(3)]


def test_variable_index_and_deposit_info():
    rng = random.Random(81)
    for v in [0, 1, 255, 256, 1000] + [rng.randrange(1 << 20) for _ in range(8)]:
        t, j = tdb.VariableIndex(v), jdb.VariableIndex(v)
        assert t.value == j.value and t.to_hex() == j.to_hex()
        assert t.to_hash_out().elements == j.to_hash_out().elements
        assert tdb.VariableIndex.from_hex(t.to_hex()) == t
        assert tdb.VariableIndex.from_hash_out(t.to_hash_out()) == t
        out_t, out_j = [], []
        t.write(out_t)
        j.write(out_j)
        assert out_t == out_j and tdb.VariableIndex.read(iter(out_t)) == t
    for t, j in zip(_deposits(random.Random(82), TAddress, tdb.VariableIndex, tdb.DepositInfo),
                    _deposits(random.Random(82), JAddress, jdb.VariableIndex, jdb.DepositInfo)):
        assert t.to_json() == j.to_json()
        assert tdb.DepositInfo.from_json(json.loads(json.dumps(t.to_json()))) == t


def test_assets_equal_jax():
    rng = random.Random(83)
    for _ in range(6):
        contract, index, receiver = rng.randrange(1 << 40), rng.randrange(256), rng.randrange(1 << 40)
        amount = rng.randrange(1 << 50)
        tk = tasset.TokenKind(TAddress(contract), tdb.VariableIndex(index))
        jk = jasset.TokenKind(JAddress(contract), jdb.VariableIndex(index))
        assert tk.to_bytes() == jk.to_bytes() and len(tk.to_bytes()) == 32
        assert tasset.TokenKind.from_bytes(tk.to_bytes()) == tk
        assert tasset.TokenKind.from_json(tk.to_json()) == tk
        assert tasset.Asset(tk, amount).to_json() == jasset.Asset(jk, amount).to_json()
        tc = tasset.ContributedAsset(TAddress(receiver), tk, amount)
        jc = jasset.ContributedAsset(JAddress(receiver), jk, amount)
        assert tc.to_json() == jc.to_json()
        assert tc.to_deposit_info().to_json() == jc.to_deposit_info().to_json()
        assert tasset.ContributedAsset.from_deposit_info(tc.to_deposit_info()) == tc
        assert tasset.ContributedAsset.from_json(tc.to_json()) == tc


def test_make_deposit_proof_equals_jax():
    lists_t = [_deposits(random.Random(84 + i), TAddress, tdb.VariableIndex, tdb.DepositInfo)
               for i in range(3)]
    lists_j = [_deposits(random.Random(84 + i), JAddress, jdb.VariableIndex, jdb.DepositInfo)
               for i in range(3)]
    receiver = lists_t[1][0].receiver_address
    got = tdep.make_deposit_proof(*lists_t, receiver, 2)
    want = jdep.make_deposit_proof(*lists_j, JAddress.from_hex(receiver.to_hex()), 2)
    assert len(got) == len(want) == 3
    for (t1, t2), (j1, j2) in zip(got, want):
        assert t1.root.elements == j1.root.elements
        assert [s.elements for s in t1.siblings] == [s.elements for s in j1.siblings]
        assert t2.to_json() == j2.to_json()


def test_block_info_json_round_trip_equals_jax():
    o = json.loads(BLOCK1_INFO.read_text())
    t, j = tblock.BlockInfo.from_json(o), jblock.BlockInfo.from_json(o)
    assert t.to_json() == j.to_json() == o
    assert tblock.BlockInfo.from_json(json.loads(json.dumps(t.to_json(), indent=1))) == t
    assert tblock.BlockInfo.new(2).to_json() == jblock.BlockInfo.new(2).to_json()
    senders = [a.sender_address for a in t.address_list]
    assert tal.make_address_list(
        [SimpleNamespace(sender_address=s) for s in senders], [None, object()]
    ) == [tal.TransactionSenderWithValidity(senders[0], False),
          tal.TransactionSenderWithValidity(senders[1], True)]


def _public_inputs(module, address, variable_index, info, hash_cls, sender_cls):
    rng = random.Random(85)
    digest = lambda: hash_cls(tuple(rng.randrange(P) for _ in range(4)))  # noqa: E731
    return module.BlockProductionPublicInputs(
        address_list=[sender_cls(address(rng.randrange(1 << 40)), bool(i % 2)) for i in range(4)],
        deposit_list=_deposits(rng, address, variable_index, info)[:2],
        scroll_flag_list=_deposits(rng, address, variable_index, info)[:2],
        polygon_flag_list=_deposits(rng, address, variable_index, info)[:2],
        old_account_tree_root=digest(), new_account_tree_root=digest(),
        old_world_state_root=digest(), new_world_state_root=digest(),
        old_prev_block_header_digest=digest(), new_prev_block_header_digest=digest(),
        block_hash=digest())


def test_block_production_public_inputs_equal_jax():
    t = _public_inputs(trc, TAddress, tdb.VariableIndex, tdb.DepositInfo, THash,
                       tal.TransactionSenderWithValidity)
    j = _public_inputs(jrc, JAddress, jdb.VariableIndex, jdb.DepositInfo, JHash,
                       jal.TransactionSenderWithValidity)
    assert t.encode() == j.encode() and len(t.encode()) == 5 * 4 + 13 * 6 + 28
    assert t.to_json() == j.to_json()
    assert t.get_entry_hash().elements == j.get_entry_hash().elements
    assert trc.BlockProductionPublicInputs.decode(t.encode(), 4, 2, 2, 2) == t
    assert trc.BlockProductionPublicInputs.from_json(json.loads(json.dumps(t.to_json()))) == t


# --------------------------------------------------------------------------
# the gadgets, each alone in a circuit at MINI
# --------------------------------------------------------------------------


def gadget_golden():
    """{gadget: (rows, digest)} of the JAX package's builds."""
    out = {}
    for line in (GOLDEN / "rollup_gadgets_mini.sha256").read_text().splitlines():
        if line.startswith("#"):
            continue
        name, tag, *limbs = line.split()[:6]
        assert tag == "circuit_digest"
        out[name] = (int(line.split(";")[1].split()[0]), tuple(int(x) for x in limbs))
    return out


@pytest.mark.parametrize("name", rg.GADGETS)
def test_gadget_circuit_equals_jax(name):
    held = {}

    def recording(self):
        held["state"] = _state(self)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(JBuilder, "build", recording)
        _, jwitness = rg.make("intmax_zkp_core_tpu", name)
    build = tcircuit.CircuitBuilder.build

    def port_recording(self):
        held["port"] = _state(self)
        return build(self)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tcircuit.CircuitBuilder, "build", port_recording)
        data, witness = rg.make("intmax_zkp_core_tpu_torch", name, device="cpu")
    for k in BUILDER_STATE:
        assert held["port"][k] == held["state"][k], k
    rows, digest = gadget_golden()[name]
    assert data.common.n == rows
    assert tuple(data.common.circuit_digest) == digest

    pw, jpw = TWitness(), JWitness()
    expected = witness(pw)
    assert jwitness(jpw) == expected
    assert pw.values == jpw.values
    assert data.check_witness(pw) == expected
    view = copy.copy(data.prover)
    view.__dict__.pop("_fill_plan", None)
    _, jpi = jprover.compute_wire_matrix(view, jpw)
    assert [int(v) for v in jpi] == expected
    # a witness the gadget refuses: one public input off
    bad = TWitness()
    bad.values.update(pw.values)
    t = data.prover.public_input_targets[0]
    bad.values[t] = (expected[0] + 1) % P
    with pytest.raises(AssertionError):
        data.check_witness(bad)


# --------------------------------------------------------------------------
# the flow in check mode, and the recursive block circuit's records
# --------------------------------------------------------------------------


@pytest.fixture(scope="module")
def flow():
    return tflow.run_block_flow(prove=False, device="cpu")


def test_block_flow_check_mode_gives_block1_info(flow):
    info = flow.block_info
    assert info.to_json() == json.loads(BLOCK1_INFO.read_text())
    assert flow.block_proof.get_entry_hash().elements == ENTRY_HASH
    # tests/test_block_flow.py's checks
    assert info.header.block_number == 2
    assert len(info.transactions) == 2 and len(info.deposit_list) == 1
    assert [a.is_valid for a in info.address_list] == [False, True]
    assert info.header.approved_world_state_digest != info.header.proposed_world_state_digest
    assert tblock.BlockInfo.from_json(json.loads(json.dumps(info.to_json()))) == info
    (mp,) = flow.merge_proofs
    assert MergeProof.from_json(json.loads(json.dumps(mp.to_json()))) == mp
    pis = flow.block_proof
    assert trc.BlockProductionPublicInputs.from_json(json.loads(json.dumps(pis.to_json()))) == pis
    # the trusted-aggregation block circuit of check mode, and its inner checks
    assert all(t.proof_target is None for t in flow.block_circuit.targets.user_tx_proofs)
    assert all(hasattr(p, "public_inputs") for p in flow.stages.signature_proofs)


def test_block_detail_json_round_trip(flow):
    # the flow's detail, its inner proofs left out (check mode has none)
    detail = copy.copy(flow.block_detail)
    detail.user_tx_proofs, detail.received_signature_proofs = [], [None, None]
    o = json.loads(json.dumps(detail.to_json()))
    assert o["block_number"] == 2 and len(o["world_state_revert_proofs"]) == 2
    assert trc.BlockDetail.from_json(o).to_json() == o
    new = trc.BlockDetail.new(2)
    assert trc.BlockDetail.from_json(json.loads(json.dumps(new.to_json()))).to_json() == \
        new.to_json()


def test_recursive_block_circuit_records_equal_jax(flow):
    """The flagship's block circuit at test_constants, inner proofs verified
    in the circuit, built on the flow's inner circuits: the builder's records
    before ``build()`` hash to those of the JAX package's builder
    (``golden/block_records_standard.sha256``, made by
    ``experiments/make_block_goldens.py records``)."""
    held = {}

    def recording(self):
        held["builder"] = self

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tcircuit.CircuitBuilder, "build", recording)
        trc.make_block_proof_circuit(
            TConstants.test_constants(), flow.stages.user_tx_circuit, flow.stages.zkdsa_circuit,
            recursive=True, device="cpu")
    builder = held["builder"]
    assert 1 << 15 < len(builder.rows) <= 1 << 16  # 65,536 rows once padded
    assert sum(r[0] == "ext_inverse" for r in builder.generators) == 1240
    want = (GOLDEN / "block_records_standard.sha256").read_text().split()[0]
    assert rg.records_sha256(builder) == want


def test_entry_points_raise_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError):
        tflow.run_block_flow(prove=False)
    with pytest.raises(RuntimeError):
        trc.make_block_proof_circuit(TConstants.test_constants(), None, None)
    from intmax_zkp_core_tpu_torch.models.rollup import mini_block

    with pytest.raises(RuntimeError):
        mini_block.build_mini_circuits()
