"""The port's in-circuit recursion (``engine/recursion.py``,
``models/recursion/gadgets.py``) against the JAX package: the port version
of ``test_recursion.py``.

The circuit is the JAX test's: an outer circuit that verifies a zkDSA proof
in the circuit (transcript replay, the vanishing identity at zeta, the FRI
queries) and registers the inner public inputs as its own, at
``CircuitConfig(fri=FriConfig(num_query_rounds=3, proof_of_work_bits=2))``.
The port's builder holds the JAX builder's records before ``build()`` (the
JAX builder works from the same inner circuit's verifier data); the port's
outer circuit has the JAX build's rows and digest
(``golden/recursion_zkdsa.sha256``, made by
``experiments/make_block_goldens.py recursion``).  The outer witness passes
``check_witness``, with the inner public inputs as its own, for an inner
proof the port makes and for one the JAX package made
(``golden/recursion_zkdsa_inner.json``, read through the port's
``engine/serde.py::proof_from_json``); a tampered inner proof is refused.
The host C++ fill gives the Python ``WitnessFill``'s wire matrix and the
JAX package's on this circuit, whose generator records include the
in-circuit verifier's ``ext_inverse``.  Proof values given as int64 bit
patterns (negative from 2^63 up) set the same witness.  The outer proof
itself is made on the card (``test_torch_cuda.py``).  Tolerance 0.
"""

import copy
import hashlib
import json
import pathlib
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from intmax_zkp_core_tpu.engine import prover as jprover
from intmax_zkp_core_tpu.engine.circuit import CircuitBuilder as JBuilder
from intmax_zkp_core_tpu.engine.circuit import CommonCircuitData as JCommon
from intmax_zkp_core_tpu.engine.config import CircuitConfig as JConfig, FriConfig as JFri
from intmax_zkp_core_tpu.engine.witness import PartialWitness as JWitness
from intmax_zkp_core_tpu.models.recursion.gadgets import RecursiveProofTarget as JRecursive
from intmax_zkp_core_tpu_torch.engine import circuit as tcircuit
from intmax_zkp_core_tpu_torch.engine import prover as tprover
from intmax_zkp_core_tpu_torch.engine import recursion as trec
from intmax_zkp_core_tpu_torch.engine.config import CircuitConfig as TConfig, FriConfig as TFri
from intmax_zkp_core_tpu_torch.engine.serde import proof_from_json, proof_to_json
from intmax_zkp_core_tpu_torch.engine.witness import PartialWitness as TWitness
from intmax_zkp_core_tpu_torch.models.recursion.gadgets import (
    CheckedPublicInputs,
    RecursiveProofTarget,
)
from intmax_zkp_core_tpu_torch.models.zkdsa.circuits import make_simple_signature_circuit
from intmax_zkp_core_tpu_torch.utils.hash_out import HashOut
from intmax_zkp_core_tpu_torch.utils.poseidon_host import two_to_one

P = 0xFFFFFFFF00000001
GOLDEN = pathlib.Path(__file__).resolve().parent.parent / "intmax_zkp_core_tpu_torch" / "golden"
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


def golden():
    """(rows, digest, the JAX inner proof's hash) of the JAX package's build."""
    lines = [ln for ln in (GOLDEN / "recursion_zkdsa.sha256").read_text().splitlines()
             if not ln.startswith("#")]
    tag, *limbs = lines[0].split()[:5]
    assert tag == "circuit_digest"
    rows = int(lines[0].split(";")[1].split()[0])
    return rows, tuple(int(x) for x in limbs), lines[1].split()[0]


def proof_sha256(proof):
    return hashlib.sha256(json.dumps(proof_to_json(proof), sort_keys=True).encode()).hexdigest()


def _jax_records(common):
    """The JAX builder's records for the same outer circuit, from the port's
    inner verifier data handed over as plain values; ``build()`` is not run
    (it compiles for seconds on a CPU)."""
    jcommon = JCommon(
        config=JConfig(fri=JFri(num_query_rounds=3, proof_of_work_bits=2)), n=common.n,
        gate_ids=list(common.gate_ids), n_sel=common.n_sel, n_const_cols=common.n_const_cols,
        k_is=list(common.k_is), num_public_inputs=common.num_public_inputs,
        circuit_digest=tuple(common.circuit_digest),
        constants_sigmas_cap=[tuple(d) for d in common.constants_sigmas_cap])
    builder = JBuilder(jcommon.config)
    target = JRecursive.add_virtual_to(builder, SimpleNamespace(common=jcommon), in_circuit=True)
    builder.register_public_inputs(list(target.public_inputs))
    return _state(builder), target


@pytest.fixture(scope="module")
def setup():
    cfg = TConfig(fri=TFri(num_query_rounds=3, proof_of_work_bits=2))
    inner = make_simple_signature_circuit(cfg, device="cpu")
    held = {}
    build = tcircuit.CircuitBuilder.build

    def recording(self):
        held["state"] = _state(self)
        return build(self)

    builder = tcircuit.CircuitBuilder(cfg, device="cpu")
    target = RecursiveProofTarget.add_virtual_to(builder, inner.data, in_circuit=True)
    builder.register_public_inputs(list(target.public_inputs))
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tcircuit.CircuitBuilder, "build", recording)
        outer = builder.build()
    jstate, jtarget = _jax_records(inner.data.common)
    sk, msg = HashOut.from_u32(7), HashOut.from_u32(555)
    proof = inner.prove(sk, msg)
    inner.verify(proof)
    return SimpleNamespace(inner=inner, outer=outer, target=target, state=held["state"],
                           jstate=jstate, jtarget=jtarget, proof=proof, sk=sk, msg=msg)


def witness(setup, proof):
    pw = TWitness()
    setup.target.set_witness(pw, proof, True)
    return pw


def jax_inner_proof():
    text = (GOLDEN / "recursion_zkdsa_inner.json").read_text()
    return proof_from_json(json.loads(text))


def test_outer_records_equal_jax(setup):
    for k in BUILDER_STATE:
        assert setup.state[k] == setup.jstate[k], k


def test_outer_rows_and_digest_equal_jax(setup):
    rows, digest, _ = golden()
    common = setup.outer.common
    assert common.n == rows == 2048
    assert tuple(common.circuit_digest) == digest
    kinds = {rec[0] for rec in setup.outer.prover.generators}
    assert "ext_inverse" in kinds


def test_outer_witness_with_port_inner_proof(setup):
    pis = setup.outer.check_witness(witness(setup, setup.proof))
    assert pis == setup.proof.public_inputs
    assert pis[8:12] == list(two_to_one(setup.sk, setup.msg).elements)


def test_outer_witness_with_jax_inner_proof(setup):
    proof = jax_inner_proof()
    assert proof_sha256(proof) == golden()[2]
    setup.inner.verify(proof)
    pis = setup.outer.check_witness(witness(setup, proof))
    assert pis == proof.public_inputs
    assert pis[8:12] == list(two_to_one(HashOut.from_u32(11), HashOut.from_u32(222)).elements)


def _tamper(proof, what):
    bad = copy.deepcopy(proof)
    if what == "public_input":  # claim a different signature
        bad.public_inputs[8] = (bad.public_inputs[8] + 1) % P
    elif what == "pow_witness":
        bad.fri.pow_witness += 1
    elif what == "opening":
        c0, c1 = bad.openings["wires"][3]
        bad.openings["wires"][3] = ((c0 + 1) % P, c1)
    else:  # a wire leaf opened by the first query
        leaf, path = bad.initial_openings[0]["wires"]
        bad.initial_openings[0]["wires"] = ([(leaf[0] + 1) % P] + list(leaf[1:]), path)
    return bad


@pytest.mark.parametrize("what", ["public_input", "pow_witness", "opening", "query_leaf"])
def test_outer_refuses_a_tampered_inner_proof(setup, what):
    with pytest.raises(AssertionError):
        setup.outer.check_witness(witness(setup, _tamper(setup.proof, what)))


def test_native_fill_equals_witness_fill_and_jax(setup):
    pd = setup.outer.prover
    pw = witness(setup, setup.proof)
    native, native_pi = tprover.compute_wire_matrix(pd, pw)
    plain, plain_pi = tprover.compute_wire_matrix_plain(pd, pw)
    assert (native == plain).all() and native_pi == plain_pi
    jpw = JWitness()
    setup.jtarget.set_witness(jpw, setup.proof, True)
    assert jpw.values == pw.values
    view = copy.copy(pd)
    view.__dict__.pop("_fill_plan", None)
    jw, jpi = jprover.compute_wire_matrix(view, jpw)
    assert (native == np.asarray(jw)).all()
    assert [int(v) for v in native_pi] == [int(v) for v in jpi]


def _as_int64_patterns(proof):
    """The proof with every value from 2^63 up written as the negative int
    of its int64 bit pattern, as a tensor's ``tolist()`` gives it."""
    signed = lambda v: v - (1 << 64) if v >= 1 << 63 else v  # noqa: E731
    bad = copy.deepcopy(proof)
    bad.openings = {k: [tuple(signed(x) for x in o) for o in v] for k, v in bad.openings.items()}
    bad.fri.final_poly = [tuple(signed(x) for x in c) for c in bad.fri.final_poly]
    bad.wires_cap = [tuple(signed(x) for x in d) for d in bad.wires_cap]
    bad.fri.query_rounds = [[([signed(x) for x in leaf], [tuple(signed(x) for x in d) for d in path])
                             for leaf, path in per] for per in bad.fri.query_rounds]
    bad.initial_openings = [{k: ([signed(x) for x in leaf], path) for k, (leaf, path) in per.items()}
                            for per in bad.initial_openings]
    return bad


def test_values_from_2_63_given_as_int64_bit_patterns(setup):
    high = [v for o in setup.proof.openings["wires"] for v in o if v >= 1 << 63]
    assert high, "the proof has no opening from 2^63 up"
    signed = _as_int64_patterns(setup.proof)
    assert any(v < 0 for o in signed.openings["wires"] for v in o)
    pw, pw_signed = witness(setup, setup.proof), witness(setup, signed)
    assert pw_signed.values == pw.values
    assert setup.outer.check_witness(pw_signed) == setup.proof.public_inputs
    assert trec._u64(-1) == (1 << 64) - 1


def test_trusted_aggregation_mode(setup):
    # in_circuit=False: the host verifies the inner proof at witness time
    builder = tcircuit.CircuitBuilder(setup.inner.data.common.config, device="cpu")
    target = RecursiveProofTarget.add_virtual_to(builder, setup.inner.data, in_circuit=False)
    assert target.proof_target is None
    pw = TWitness()
    target.set_witness(pw, setup.proof, True)
    assert [pw.values[t] for t in target.public_inputs] == setup.proof.public_inputs
    target.set_witness(TWitness(), CheckedPublicInputs(setup.proof.public_inputs), False)
    with pytest.raises(AssertionError):
        target.set_witness(TWitness(), _tamper(setup.proof, "pow_witness"), True)


def test_entry_points_raise_without_cuda(setup):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError):
        tcircuit.CircuitBuilder(setup.inner.data.common.config)
