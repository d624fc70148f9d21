"""The port's in-circuit ECDSA (``models/ecdsa/``, ``bin/ecdsa_verification.py``)
against the JAX package: the port version of ``test_ecdsa_circuit.py``.

Host functions: secp256k1 accounts, signatures and their byte codecs on
seeded keys, equal to the JAX package's.

The gadgets (the ``u32_mul_add`` gate, the non-native arithmetic mod n, curve
addition and doubling, both scalar multipliers at small ``n_bits``), each
alone in a circuit: the port's builder holds the JAX builder's records before
``build()`` (the JAX ``build()`` is not run: its commit costs seconds), the
port's ``check_witness`` gives the values the JAX test expects, and the
native fill's wire matrix equals the plain ``WitnessFill``'s and the JAX
package's fill's on the same records.  These circuits are only checked, not
proved (but the gate's), so they are built at blowup 2: ``check_witness``
evaluates the constraints on the subgroup, and the records do not depend on
the FRI config.

The verification circuit at ``n_bits = 16`` (the demo's contrived
small-exponent triple, which has all three ECDSA generator kinds) at the JAX
test's tiny config: records equal to the JAX builder's, rows and digest equal
to the JAX build's and its one proof's hash to the JAX proof's
(``golden/ecdsa_16_test.sha256``, made by ``experiments/make_ecdsa_goldens.py
16``), the native fill equal to ``WitnessFill`` and to the JAX fill.  The
256-bit circuit is proved on the card (``chip_smoke.py``). Tolerance 0.
"""

import copy
import hashlib
import importlib
import json
import os
import pathlib
import random
import subprocess
import sys
import textwrap
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from intmax_zkp_core_tpu.engine import prover as jprover
from intmax_zkp_core_tpu.engine.witness import PartialWitness as JWitness
from intmax_zkp_core_tpu_torch.bin.ecdsa_verification import demo_triple
from intmax_zkp_core_tpu_torch.engine import circuit as tcircuit
from intmax_zkp_core_tpu_torch.engine import circuit_cache as cc
from intmax_zkp_core_tpu_torch.engine import prover as tprover
from intmax_zkp_core_tpu_torch.engine.serde import proof_to_json
from intmax_zkp_core_tpu_torch.engine.witness import PartialWitness as TWitness

ROOT = pathlib.Path(__file__).resolve().parent.parent
GOLDEN = ROOT / "intmax_zkp_core_tpu_torch" / "golden"
BUILDER_STATE = ("rows", "generators", "parent", "targets_at_place", "preset_values",
                 "public_input_targets")
ECDSA_KINDS = {"ecdsa_biguint", "ecdsa_mul_quotient", "ecdsa_overflow_count"}


def package(prefix: str) -> SimpleNamespace:
    m = lambda name: importlib.import_module(f"{prefix}.{name}")  # noqa: E731
    config = m("engine.config")
    return SimpleNamespace(
        CircuitBuilder=m("engine.circuit").CircuitBuilder, CircuitConfig=config.CircuitConfig,
        FriConfig=config.FriConfig, account=m("models.ecdsa.account"),
        gadgets=m("models.ecdsa.gadgets"), circuits=m("models.ecdsa.circuits"))


JAX, PORT = package("intmax_zkp_core_tpu"), package("intmax_zkp_core_tpu_torch")



def tiny_config(pkg, rate_bits=3):
    """The JAX test's tiny config; ``rate_bits=1`` for circuits only checked."""
    return pkg.CircuitConfig(fri=pkg.FriConfig(rate_bits=rate_bits, num_query_rounds=6,
                                               proof_of_work_bits=4))


def _state(builder):
    """The builder's records as they stand (its ``build()`` goes on to add
    to them): each container copied one level down, where ``build()`` writes."""
    return {"rows": [(g, list(c)) for g, c in builder.rows],
            "generators": [tuple(r) for r in builder.generators],
            "parent": list(builder.parent),
            "targets_at_place": dict(builder.targets_at_place),
            "preset_values": dict(builder.preset_values),
            "public_input_targets": list(builder.public_input_targets)}


def proof_sha256(proof):
    return hashlib.sha256(json.dumps(proof_to_json(proof), sort_keys=True).encode()).hexdigest()


def golden(name):
    """{"gate_rows", "rows", "digest", "proof"} of ``golden/<name>.sha256``."""
    lines = [ln for ln in (GOLDEN / f"{name}.sha256").read_text().splitlines()
             if not ln.startswith("#")]
    assert lines[0].split()[0] == "gate_rows" and lines[1].split()[0] == "circuit_digest"
    return {"gate_rows": int(lines[0].split()[1]),
            "rows": int(lines[1].split(";")[1].split()[0]),
            "digest": tuple(int(x) for x in lines[1].split()[1:5]),
            "proof": lines[2].split()[0]}


# --------------------------------------------------------------------------
# host functions
# --------------------------------------------------------------------------


def _seeded_keys(n=4):
    rng = random.Random(20261017)
    return [rng.randrange(1, JAX.account.N256) for _ in range(n)]


@pytest.mark.parametrize("i", range(4))
def test_account_and_signature_equal_jax(i):
    key = _seeded_keys()[i]
    msg = random.Random(i).getrandbits(256)
    ta, ja = PORT.account.private_key_to_account(key), JAX.account.private_key_to_account(key)
    assert ta.public_key == ja.public_key
    assert ta.address.elements == ja.address.elements
    assert PORT.account.public_key_to_address(ta.public_key) == ta.address
    sig = PORT.account.sign_message(key, msg)
    assert sig == JAX.account.sign_message(key, msg)
    assert PORT.account.verify_message(ta.public_key, msg, sig)
    assert not PORT.account.verify_message(ta.public_key, msg + 1, sig)
    assert not PORT.account.verify_message(ta.public_key, msg, (sig[0], sig[1] + 1))
    assert PORT.account.point_mul(key) == JAX.account.point_mul(key)


@pytest.mark.parametrize("i", range(4))
def test_byte_codecs_round_trip_and_equal_jax(i):
    key = _seeded_keys()[i]
    acct = PORT.account.private_key_to_account(key)
    sig = PORT.account.sign_message(key, 0xDEADBEEF + i)
    packed = PORT.account.pack_signature(sig)
    assert packed == JAX.account.pack_signature(sig) and len(packed) == 64
    assert PORT.account.unpack_signature(packed) == sig
    point = PORT.account.pack_point(acct.public_key)
    assert point == JAX.account.pack_point(acct.public_key)
    assert PORT.account.unpack_point(point) == acct.public_key
    assert PORT.account.unpack_scalar(PORT.account.pack_scalar(key)) == key


def test_demo_triples_verify():
    for n_bits in (256, 16, 4):
        msg, sig, pk = demo_triple(n_bits)
        assert JAX.account.verify_message(pk, msg, sig)
        if n_bits < 256:  # the verifier's scalars fit n_bits
            c = pow(sig[1], -1, JAX.account.N256)
            assert msg * c % JAX.account.N256 < 1 << n_bits
            assert sig[0] * c % JAX.account.N256 < 1 << n_bits


# --------------------------------------------------------------------------
# the gadgets, each alone in a circuit
# --------------------------------------------------------------------------


def _biguint_pis(builder, big):
    for limb in big.limbs:
        builder.register_public_input(limb)


def _gate(pkg, b):
    a, bb, c = b.add_virtual_target(), b.add_virtual_target(), b.add_virtual_target()
    lo, hi = b.u32_mul_add(a, bb, c)
    for t in (a, bb, c, lo, hi):
        b.register_public_input(t)
    av = bv = cv = 0xFFFFFFFF  # the largest case: v = p - 1
    v = av * bv + cv

    def witness(pw):
        for t, x in zip((a, bb, c), (av, bv, cv)):
            pw.set_target(t, x)
    return witness, [av, bv, cv, v & 0xFFFFFFFF, v >> 32]


def _nonnative(pkg, b):
    g, n = pkg.gadgets, pkg.account.N256
    x_v = 0xDEADBEEF_CAFEBABE_12345678_9ABCDEF0_0F1E2D3C_4B5A6978_87695A4B_3C2D1E0F
    y_v = n - 0x1234567890ABCDEF
    x, y = g.add_virtual_biguint(b), g.add_virtual_biguint(b)
    for big in (g.mul_nonnative(b, x, y, n), g.add_nonnative(b, x, y, n),
                g.sub_nonnative(b, x, y, n), g.inv_nonnative(b, x, n)):
        _biguint_pis(b, big)

    def witness(pw):
        g.set_biguint_witness(pw, x, x_v)
        g.set_biguint_witness(pw, y, y_v)
    want = [x_v * y_v % n, (x_v + y_v) % n, (x_v - y_v) % n, pow(x_v, -1, n)]
    return witness, [limb for v in want for limb in g.limbs_of(v)]


def _curve(pkg, b):
    g, acc = pkg.gadgets, pkg.account
    t1 = g.constant_affine_point(b, acc.point_mul(7))
    t2 = g.constant_affine_point(b, acc.point_mul(11))
    s, dbl = g.curve_add_nonequal(b, t1, t2), g.curve_double(b, t1)
    for big in (s.x, s.y, dbl.x, dbl.y):
        _biguint_pis(b, big)
    want = [*acc.point_mul(18), *acc.point_mul(14)]
    return (lambda pw: None), [limb for v in want for limb in g.limbs_of(v)]


def _scalar_mul_constant_base(pkg, b):
    g, acc = pkg.gadgets, pkg.account
    scalar_v = 0xE5  # 8 bits, so the trimmed multiplier is sound (16 in the circuit below)
    scalar = g.add_virtual_biguint(b)
    out = g.curve_scalar_mul_constant_base(b, (acc.GX, acc.GY), scalar, n_bits=8)
    _biguint_pis(b, out.x)
    _biguint_pis(b, out.y)
    want = acc.point_mul(scalar_v)
    return (lambda pw: g.set_biguint_witness(pw, scalar, scalar_v)), \
        [limb for v in want for limb in g.limbs_of(v)]


def _scalar_mul_variable_base(pkg, b):
    g, acc = pkg.gadgets, pkg.account
    scalar_v, base = 0xD, acc.point_mul(1234567)  # 4 bits: the trimmed multiplier is sound
    scalar = g.add_virtual_biguint(b)
    out = g.curve_scalar_mul(b, g.constant_affine_point(b, base), scalar, n_bits=4)
    _biguint_pis(b, out.x)
    _biguint_pis(b, out.y)
    want = acc.point_mul(scalar_v, base)
    return (lambda pw: g.set_biguint_witness(pw, scalar, scalar_v)), \
        [limb for v in want for limb in g.limbs_of(v)]


GADGETS = {"u32_mul_add": _gate, "nonnative_mod_n": _nonnative, "curve_add_double": _curve,
           "scalar_mul_constant_base": _scalar_mul_constant_base,
           "scalar_mul_variable_base": _scalar_mul_variable_base}


def built(make, rate_bits=1):
    """The gadget ``make`` in both packages' builders: the port's circuit
    built on the CPU with its records as they stood before ``build()``, the
    JAX builder's records, and each side's witness function."""
    held = {}
    build = tcircuit.CircuitBuilder.build

    def recording(self):
        held["state"] = _state(self)
        return build(self)

    builder = PORT.CircuitBuilder(tiny_config(PORT, rate_bits), device="cpu")
    witness, want = make(PORT, builder)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tcircuit.CircuitBuilder, "build", recording)
        data = builder.build()
    jbuilder = JAX.CircuitBuilder(tiny_config(JAX, rate_bits))
    jwitness, jwant = make(JAX, jbuilder)
    assert jwant == want
    return SimpleNamespace(data=data, state=held["state"], jstate=_state(jbuilder),
                           witness=witness, jwitness=jwitness, want=want)


def fills_agree(data, pw, jpw):
    """The native fill's wire matrix and public inputs equal the plain
    ``WitnessFill``'s and the JAX package's fill's on the same records."""
    pd = data.prover
    native, native_pi = tprover.compute_wire_matrix(pd, pw)
    plain, plain_pi = tprover.compute_wire_matrix_plain(pd, pw)
    assert (native == plain).all() and native_pi == plain_pi
    view = copy.copy(pd)
    view.__dict__.pop("_fill_plan", None)
    jw, jpi = jprover.compute_wire_matrix(view, jpw)
    assert (native == np.asarray(jw)).all()
    assert [int(v) for v in native_pi] == [int(v) for v in jpi]
    return [int(v) for v in native_pi]


@pytest.mark.parametrize("name", GADGETS)
def test_gadget_circuit_equals_jax(name):
    c = built(GADGETS[name])
    for k in BUILDER_STATE:
        assert c.state[k] == c.jstate[k], k
    pw, jpw = TWitness(), JWitness()
    c.witness(pw)
    c.jwitness(jpw)
    assert pw.values == jpw.values
    assert c.data.check_witness(pw) == c.want
    assert fills_agree(c.data, pw, jpw) == c.want
    kinds = {rec[0] for rec in c.data.prover.generators}
    assert "u32_mul_add" in kinds
    if name not in ("u32_mul_add", "scalar_mul_constant_base"):
        assert ECDSA_KINDS <= kinds


def test_u32_mul_add_gate_proves_and_verifies():
    c = built(_gate, rate_bits=3)
    pw = TWitness()
    c.witness(pw)
    proof = c.data.prove(pw)
    assert proof.public_inputs == c.want
    c.data.verify(proof)


def test_range_check_u32_refuses_a_large_limb():
    builder = PORT.CircuitBuilder(tiny_config(PORT, 1), device="cpu")
    t = builder.add_virtual_target()
    builder.range_check_u32(t)
    data = builder.build()
    for value, ok in ((0xFFFFFFFF, True), (1 << 32, False)):
        pw = TWitness()
        pw.set_target(t, value)
        if ok:
            data.check_witness(pw)
        else:
            with pytest.raises(AssertionError):
                data.check_witness(pw)


def test_nonnative_mul_refuses_a_wrong_product():
    g, n = PORT.gadgets, PORT.account.N256
    builder = PORT.CircuitBuilder(tiny_config(PORT, 1), device="cpu")
    x, out = g.add_virtual_biguint(builder), g.add_virtual_biguint(builder)
    g.mul_nonnative_into(builder, x, x, out, n)
    data = builder.build()
    for value, ok in ((123456789**2, True), (123456789**2 + 1, False)):
        pw = TWitness()
        g.set_biguint_witness(pw, x, 123456789)
        g.set_biguint_witness(pw, out, value)
        if ok:
            data.check_witness(pw)
        else:
            with pytest.raises(AssertionError):
                data.check_witness(pw)


# --------------------------------------------------------------------------
# the verification circuit
# --------------------------------------------------------------------------


@pytest.fixture(scope="module")
def ecdsa16():
    """The n_bits = 16 verification circuit at the tiny config, built once."""
    msg, sig, pk = demo_triple(16)
    held = {}
    build = tcircuit.CircuitBuilder.build

    def recording(self):
        held["state"] = _state(self)
        return build(self)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tcircuit.CircuitBuilder, "build", recording)
        circuit = PORT.circuits.make_ecdsa_verification_circuit(
            msg, sig, pk, config=tiny_config(PORT), n_bits=16, device="cpu")
    jbuilder = JAX.CircuitBuilder(tiny_config(JAX))
    JAX.circuits.verify_message_circuit(jbuilder, msg, sig[0], sig[1], pk, n_bits=16)
    return SimpleNamespace(circuit=circuit, state=held["state"], jstate=_state(jbuilder))


def test_verification_circuit_records_equal_jax(ecdsa16):
    for k in BUILDER_STATE:
        assert ecdsa16.state[k] == ecdsa16.jstate[k], k
    assert len(ecdsa16.state["rows"]) == golden("ecdsa_16_test")["gate_rows"]
    kinds = {rec[0] for rec in ecdsa16.circuit.data.prover.generators}
    assert ECDSA_KINDS <= kinds


def test_verification_circuit_rows_and_digest_equal_jax(ecdsa16):
    want = golden("ecdsa_16_test")
    common = ecdsa16.circuit.data.common
    assert common.n == want["rows"] == 8192
    assert tuple(common.circuit_digest) == want["digest"]
    assert common.gate_ids == ["arithmetic", "constant", "noop", "public_input", "u32_mul_add"]


def test_verification_circuit_fills_agree(ecdsa16):
    assert fills_agree(ecdsa16.circuit.data, TWitness(), JWitness()) == []


def test_verification_proof_equals_jax_golden(ecdsa16):
    proof = ecdsa16.circuit.prove()
    assert proof_sha256(proof) == golden("ecdsa_16_test")["proof"]
    ecdsa16.circuit.verify(proof)
    bad = copy.deepcopy(proof)
    bad.fri.pow_witness += 1
    with pytest.raises(AssertionError):
        ecdsa16.circuit.verify(bad)


FRESH = textwrap.dedent("""
    import hashlib, sys
    from intmax_zkp_core_tpu_torch.engine import circuit_cache as cc
    from intmax_zkp_core_tpu_torch.engine.generators import GENERATOR_KINDS
    from intmax_zkp_core_tpu_torch.engine.prover import compute_wire_matrix
    from intmax_zkp_core_tpu_torch.engine.witness import PartialWitness
    assert "ecdsa_biguint" not in GENERATOR_KINDS
    circuit = cc.bind_device(cc.read_circuit(sys.argv[1]), "cpu")
    assert "ecdsa_biguint" in GENERATOR_KINDS
    assert "intmax_zkp_core_tpu_torch.models.ecdsa.gadgets" in sys.modules
    wires, pis = compute_wire_matrix(circuit.data.prover, PartialWitness())
    print(hashlib.sha256(wires.tobytes()).hexdigest(), len(pis))
""")


def test_fresh_interpreter_fills_the_unpickled_circuit(ecdsa16, tmp_path):
    """The circuit cache's file of this circuit, read by a fresh interpreter
    that has not imported the ECDSA model: unpickling imports it (through
    ``EcdsaVerificationCircuit``), which registers its generator kinds, and
    the witness fills to the same wire matrix."""
    wires, pis = tprover.compute_wire_matrix(ecdsa16.circuit.data.prover, TWitness())
    path = str(tmp_path / "ecdsa16.ckt")
    cc.write_circuit(path, ecdsa16.circuit)
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([str(ROOT), os.environ.get("PYTHONPATH", "")]))
    out = subprocess.run([sys.executable, "-c", FRESH, path], capture_output=True, text=True,
                         env=env, cwd=str(tmp_path), timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.split() == [hashlib.sha256(wires.tobytes()).hexdigest(), str(len(pis))]


def test_wrong_signature_refused():
    """The demo's 4-bit triple with s + 1: the verification circuit has no
    witness (the right triple's 16-bit circuit proves, above)."""
    msg, sig, pk = demo_triple(4)
    bad_sig = (sig[0], (sig[1] + 1) % PORT.account.N256)
    with pytest.raises(AssertionError):
        PORT.circuits.make_ecdsa_verification_circuit(
            msg, bad_sig, pk, config=tiny_config(PORT, 1), n_bits=4, device="cpu").check()


def test_entry_points_raise_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    msg, sig, pk = demo_triple(4)
    with pytest.raises(RuntimeError):
        PORT.circuits.make_ecdsa_verification_circuit(msg, sig, pk, n_bits=4)
    from intmax_zkp_core_tpu_torch.bin import ecdsa_verification

    with pytest.raises(RuntimeError):
        ecdsa_verification.main(["4", "--check-only"])
