"""The main path as a whole: build -> prove -> verify, port vs JAX package.

zkDSA and a 64-row Poseidon hash chain at ``CircuitConfig.test_config()``:
the two builders agree (digest, cap, sigma, tables), the wire matrices agree,
the proofs are equal field by field — with the port's own builder and through
``circuit_from_reference`` — each verifier accepts the other's proof and both
reject a tampered one.  Everything is exact: ``==``."""

import copy
import dataclasses

import numpy as np
import pytest
import torch

from intmax_zkp_core_tpu.engine import prover as jprover
from intmax_zkp_core_tpu.engine.circuit import CircuitBuilder as JBuilder
from intmax_zkp_core_tpu.engine.config import CircuitConfig as JConfig
from intmax_zkp_core_tpu.engine.serde import proof_to_json as j_to_json
from intmax_zkp_core_tpu.engine.witness import PartialWitness as JWitness
from intmax_zkp_core_tpu.models.zkdsa import make_simple_signature_circuit as j_make_zkdsa
from intmax_zkp_core_tpu.utils.hash_out import HashOut as JHashOut
from intmax_zkp_core_tpu_torch.engine import prover as tprover
from intmax_zkp_core_tpu_torch.engine.carry import circuit_from_reference
from intmax_zkp_core_tpu_torch.engine.config import CircuitConfig as TConfig
from intmax_zkp_core_tpu_torch.engine.serde import proof_from_json, proof_to_json as t_to_json
from intmax_zkp_core_tpu_torch.engine.witness import PartialWitness as TWitness
from intmax_zkp_core_tpu_torch.models.hash_chain import make_hash_chain_circuit
from intmax_zkp_core_tpu_torch.models.zkdsa import make_simple_signature_circuit as t_make_zkdsa
from intmax_zkp_core_tpu_torch.utils.hash_out import HashOut as THashOut

torch.set_num_threads(1)

P = 0xFFFFFFFF00000001
KEY, MESSAGE = 42, 0xABCDEF
SEED, SALT = 7, 0xC0FFEE
CHAIN_LINKS = 60  # + 4 rows of overhead = 64 rows


def reference_state(data) -> dict:
    """The JAX package's built circuit as plain data (numpy, ints, lists)."""
    pd, common = data.prover, data.common
    return {
        "config": dataclasses.asdict(common.config),
        "common": {
            "n": common.n, "gate_ids": list(common.gate_ids), "n_sel": common.n_sel,
            "n_const_cols": common.n_const_cols, "k_is": list(common.k_is),
            "num_public_inputs": common.num_public_inputs,
            "circuit_digest": tuple(common.circuit_digest),
            "constants_sigmas_cap": list(common.constants_sigmas_cap),
        },
        "rows": [(g, list(c)) for g, c in pd.rows],
        "targets_at_place": dict(pd.targets_at_place),
        "parent": list(pd.parent),
        "generators": [tuple(rec) for rec in pd.generators],
        "preset_values": dict(pd.preset_values),
        "public_input_targets": list(pd.public_input_targets),
        "constants_sigmas": np.asarray(pd.constants_sigmas),
        "cs_coeffs": np.asarray(pd.cs_coeffs),
        "cs_lde": np.asarray(pd.cs_lde),
        "cs_tree_levels": [np.asarray(lv) for lv in pd.cs_tree.levels],
        "cap_height": pd.cs_tree.cap_height,
        "sigma": np.asarray(pd.sigma),
        "w_pows": np.asarray(pd.w_pows),
    }


def _j_chain():
    b = JBuilder(JConfig.test_config())
    seed, salt = b.add_virtual_hash(), b.add_virtual_hash()
    cur = seed
    for _ in range(CHAIN_LINKS):
        cur = b.two_to_one(cur, salt)
    for h in (seed, salt, cur):
        b.register_public_inputs(list(h))
    data = b.build()
    pw = JWitness()
    pw.set_hash_target(seed, JHashOut.from_u64(SEED).elements)
    pw.set_hash_target(salt, JHashOut.from_u64(SALT).elements)
    return data, pw


@pytest.fixture(scope="module")
def zkdsa():
    jc = j_make_zkdsa(JConfig.test_config())
    tc = t_make_zkdsa(TConfig.test_config(), device="cpu")
    jpw, tpw = JWitness(), TWitness()
    jc.targets.set_witness(jpw, JHashOut.from_u64(KEY), JHashOut.from_u64(MESSAGE))
    tc.targets.set_witness(tpw, THashOut.from_u64(KEY), THashOut.from_u64(MESSAGE))
    return {"j": jc.data, "t": tc.data, "jpw": jpw, "tpw": tpw,
            "jproof": jc.data.prove(jpw), "tproof": tc.data.prove(tpw)}


@pytest.fixture(scope="module")
def chain():
    jdata, jpw = _j_chain()
    tc = make_hash_chain_circuit(CHAIN_LINKS, TConfig.test_config(), device="cpu")
    assert tc.data.common.n == 64
    tpw = tc.witness(THashOut.from_u64(SEED), THashOut.from_u64(SALT))
    return {"j": jdata, "t": tc.data, "jpw": jpw, "tpw": tpw,
            "jproof": jdata.prove(jpw), "tproof": tc.data.prove(tpw)}


@pytest.fixture(params=["zkdsa", "chain"])
def case(request):
    return request.getfixturevalue(request.param)


def test_builders_agree(case):
    j, t = case["j"], case["t"]
    assert t.common.n == j.common.n
    assert list(t.common.gate_ids) == list(j.common.gate_ids)
    assert tuple(t.common.circuit_digest) == tuple(j.common.circuit_digest)
    assert list(t.common.constants_sigmas_cap) == list(j.common.constants_sigmas_cap)
    assert list(t.common.k_is) == list(j.common.k_is)
    for name in ("sigma", "w_pows", "constants_sigmas", "cs_coeffs", "cs_lde"):
        assert (getattr(t.prover, name) == np.asarray(getattr(j.prover, name))).all(), name
    for a, b in zip(t.prover.cs_tree.levels, j.prover.cs_tree.levels):
        assert (a == np.asarray(b)).all()
    assert t.prover.rows == [(g, list(c)) for g, c in j.prover.rows]
    assert t.prover.generators == [tuple(r) for r in j.prover.generators]


def test_wire_matrix_agrees(case):
    jw, jpi = jprover.compute_wire_matrix(case["j"].prover, case["jpw"])
    tw, tpi = tprover.compute_wire_matrix(case["t"].prover, case["tpw"])
    assert (tw == np.asarray(jw)).all()
    assert [int(v) for v in tpi] == [int(v) for v in jpi]
    assert case["t"].check_witness(case["tpw"]) == [int(v) for v in jpi]


def test_proofs_equal_field_by_field(case):
    a, b = t_to_json(case["tproof"]), j_to_json(case["jproof"])
    assert set(a) == set(b)
    for key in b:
        assert a[key] == b[key], key


def test_proof_through_carried_state_equal(case):
    carried = circuit_from_reference(reference_state(case["j"]), device="cpu")
    proof = carried.prove(case["tpw"])
    assert t_to_json(proof) == j_to_json(case["jproof"])
    carried.verify(proof)


def test_each_verifier_accepts_the_others_proof(case):
    case["t"].verify(case["tproof"])
    case["j"].verify(case["jproof"])
    case["j"].verify(case["tproof"])
    case["t"].verify(proof_from_json(j_to_json(case["jproof"])))


def _tampered(proof, what):
    bad = copy.deepcopy(proof)
    if what == "opening":
        c0, c1 = bad.openings["wires"][0]
        bad.openings["wires"][0] = ((c0 + 1) % P, c1)
    elif what == "public_input":
        bad.public_inputs[0] = (bad.public_inputs[0] + 1) % P
    elif what == "pow":
        bad.fri.pow_witness += 1
    elif what == "cap":
        d = bad.wires_cap[0]
        bad.wires_cap[0] = ((d[0] + 1) % P,) + tuple(d[1:])
    return bad


@pytest.mark.parametrize("what", ["opening", "public_input", "pow", "cap"])
def test_both_reject_a_tampered_proof(case, what):
    with pytest.raises(AssertionError):
        case["t"].verify(_tampered(case["tproof"], what))
    with pytest.raises(AssertionError):
        case["j"].verify(_tampered(case["jproof"], what))


def test_fused_sponge_wiring_gives_the_same_proof(zkdsa):
    # on the CPU both wirings end in the plain version; this holds the keyword's
    # way through prove -> _commit / fold_layers / grind_pow
    proof = zkdsa["t"].prove(zkdsa["tpw"], fused_sponge=True)
    assert t_to_json(proof) == t_to_json(zkdsa["tproof"])


def test_conflicting_witness_is_refused(zkdsa):
    # a value that contradicts a constant of the circuit stops witness generation
    pw = TWitness()
    pw.values.update(zkdsa["tpw"].values)
    target, value = next(iter(zkdsa["t"].prover.preset_values.items()))
    pw.values[target] = (value + 1) % P
    with pytest.raises(AssertionError):
        zkdsa["t"].check_witness(pw)


def test_device_none_raises_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError):
        t_make_zkdsa(TConfig.test_config())
