"""The main path as a whole: build -> prove -> verify, port vs JAX package.

zkDSA and a 64-row Poseidon hash chain at ``CircuitConfig.test_config()``:
the two builders agree (digest, cap, sigma, tables), the wire matrices agree,
the proofs are equal field by field — with the port's own builder and through
``circuit_from_reference`` — each verifier accepts the other's proof and both
reject a tampered one.  Everything is exact: ``==``."""

import copy
import dataclasses
import importlib

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
from intmax_zkp_core_tpu_torch.ops import goldilocks as tgl
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


def test_fused_sponge_wiring_gives_the_same_proof(zkdsa, instrumented):
    # on the CPU both wirings end in the plain version; this holds the keyword's
    # way through prove -> _commit / fold_layers / grind_pow (the instrumented
    # proof is made with fused_sponge=True)
    assert t_to_json(instrumented["proof"]) == t_to_json(zkdsa["tproof"])


KERNEL_WRAPPERS = (
    ("perm_columns_cuda", "perm_columns_cuda", "perm_columns_plain"),
    ("perm_quotient_cuda", "perm_quotient_cuda", "perm_quotient_plain"),
    ("zinv_mul_cuda", "zinv_mul_cuda", "zinv_mul_plain"),
    ("fri_init_cuda", "fri_initial_cuda", "fri_initial_plain"),
    ("gate_quotient_cuda", "poseidon_gate_quotient_cuda", "poseidon_gate_quotient_plain"),
    ("ntt_cuda", "ntt_cuda", "ntt_plain"),
)


@pytest.fixture(scope="module")
def instrumented(zkdsa):
    """One zkDSA proof in the fused-sponge wiring, with every kernel wrapper
    replaced by a counting shim around its plain version and with ``timings``:
    the calls per wrapper, the timings and the proof."""
    calls, timings = {}, {}

    def shim(name, plain):
        def counted(*args, **kwargs):
            calls[name] = calls.get(name, 0) + 1
            return plain(*args, **kwargs)

        return counted

    with pytest.MonkeyPatch.context() as mp:
        for module, wrapper, plain in KERNEL_WRAPPERS:
            mod = importlib.import_module(f"intmax_zkp_core_tpu_torch.ops.{module}")
            mp.setattr(mod, wrapper, shim(wrapper, getattr(mod, plain)))
        proof = tprover.prove(zkdsa["t"], zkdsa["tpw"], fused_sponge=True, timings=timings)
    return {"calls": calls, "timings": timings, "proof": proof}


def test_prove_goes_through_each_kernel_wrapper_once(zkdsa, instrumented):
    # prove reaches every wrapper through its module: the four of the
    # permutation argument and the Poseidon-gate quotient exactly once per proof
    once = {wrapper: 1 for _, wrapper, _ in KERNEL_WRAPPERS if wrapper != "ntt_cuda"}
    assert {k: v for k, v in instrumented["calls"].items() if k != "ntt_cuda"} == once
    assert t_to_json(instrumented["proof"]) == j_to_json(zkdsa["jproof"])


def test_prove_goes_through_the_ntt_wrapper_at_every_ntt(instrumented):
    # the intt and coset-LDE ntt of the wires' and the Z / partial-product
    # commitments, the intt of quotient_finish, the quotient commitment's ntt
    # and the two coset_ilde of the FRI final polynomial
    assert instrumented["calls"]["ntt_cuda"] == 8


def test_timings_split_quotient_and_fri_into_parts_that_add_up(zkdsa, instrumented):
    timings = instrumented["timings"]
    assert t_to_json(instrumented["proof"]) == t_to_json(zkdsa["tproof"])
    phases = ("tables", "witness", "commit_wires", "perm_columns", "quotient", "openings", "fri")
    parts = {
        "quotient": ("quotient_perm", "quotient_gates", "quotient_finish", "quotient_commit"),
        "fri": ("fri_combine", "fri_initial", "fri_fold", "fri_grind", "fri_queries"),
    }
    assert set(timings) == set(phases) | {p for ps_ in parts.values() for p in ps_}
    for phase, names in parts.items():
        assert sum(timings[n] for n in names) == pytest.approx(timings[phase], abs=1e-9)


def test_quotient_gates_equals_the_per_constraint_fold(zkdsa):
    # the prove() path's quotient_gates (the Poseidon gate through its kernel's
    # wrapper) against every gate through the plain per-constraint fold
    pd, common = zkdsa["t"].prover, zkdsa["t"].common
    cfg = common.config
    lde_n, C = common.n * cfg.fri.blowup, cfg.num_challenges
    assert "poseidon" in common.gate_ids
    rng = np.random.default_rng(26)

    def field(*shape):
        return tgl.from_u64(rng.integers(0, P, size=shape, dtype=np.uint64), "cpu")

    wires_lde, pi_hash, alphas = field(cfg.num_wires, lde_n), field(4), field(C)
    acc, apows = field(C, lde_n), field(C)
    got = tprover.get_circuit_kernels(pd, "cpu")["quotient_gates"](wires_lde, pi_hash, alphas, acc, apows)
    cs = tgl.from_u64(pd.cs_lde, "cpu")
    const = cs[common.n_sel : common.n_sel + common.n_const_cols]
    for gi, gate_id in enumerate(common.gate_ids):
        if tprover.GATE_TYPES[gate_id].num_constraints:
            fold = tprover._gate_quotient_chunk(gate_id, cfg.num_wires, common.n_const_cols, C)
            acc, apows = fold(wires_lde, cs[gi], const, pi_hash, alphas, acc, apows)
    assert torch.equal(got, acc)


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
