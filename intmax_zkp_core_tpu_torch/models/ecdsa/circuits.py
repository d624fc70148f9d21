"""In-circuit ECDSA verification over secp256k1.

Reference: ``src/ecdsa/bin/ecdsa_verification.rs`` (cargo feature
``ecdsa``), whose ``verify_message_circuit(builder, msg, sig, pk)`` comes
from the plonky2_ecdsa dependency.  Semantics proven in-circuit:

    c  = s^-1 (mod n)
    u1 = msg * c (mod n),  u2 = r * c (mod n)
    Q  = u1 * G + u2 * pk
    assert Q.x ≡ r (mod n)

Like the reference demo, message / signature / public key enter as circuit
constants by default (``builder.constant_nonnative`` /
``constant_affine_point`` in the demo); passing targets instead makes them
witness inputs, and a non-constant public key routes through the
variable-base scalar multiplier.
"""

from __future__ import annotations

from dataclasses import dataclass

from ...engine.circuit import CircuitBuilder
from ...engine.config import CircuitConfig
from ...engine.witness import PartialWitness
from .account import GX, GY, N256
from .gadgets import (
    AffinePointTarget,
    BigUintTarget,
    _addsub_check,
    constant_biguint,
    curve_add_nonequal,
    curve_scalar_mul,
    curve_scalar_mul_constant_base,
    inv_nonnative,
    mul_nonnative,
)


def verify_message_circuit(builder: CircuitBuilder, msg, sig_r, sig_s, public_key,
                           n_bits: int = 256) -> None:
    """Emit the full ECDSA verification constraint system.

    ``msg`` / ``sig_r`` / ``sig_s`` may be ints (installed as constants,
    mirroring the reference demo) or ``BigUintTarget``s; ``public_key`` a
    coordinate tuple (constant — enables the windowed constant-base
    multiplier) or an ``AffinePointTarget``.  ``n_bits`` trims the scalar
    multipliers for cheap tests (sound only when u1, u2 < 2^n_bits)."""

    def to_big(v):
        return constant_biguint(builder, v) if isinstance(v, int) else v

    msg = to_big(msg)
    r = to_big(sig_r)
    s = to_big(sig_s)
    c = inv_nonnative(builder, s, N256)
    u1 = mul_nonnative(builder, msg, c, N256)
    u2 = mul_nonnative(builder, r, c, N256)
    p1 = curve_scalar_mul_constant_base(builder, (GX, GY), u1, n_bits=n_bits)
    if isinstance(public_key, AffinePointTarget):
        p2 = curve_scalar_mul(builder, public_key, u2, n_bits=n_bits)
    else:
        p2 = curve_scalar_mul_constant_base(builder, tuple(public_key), u2, n_bits=n_bits)
    q = curve_add_nonequal(builder, p1, p2)
    # Q.x ≡ r (mod n): Q.x < p_secp < 2n, so the overflow count is 0 or 1
    _addsub_check(builder, plus=[q.x], minus_rhs=[r], modulus=N256, ov_bound=2)


@dataclass
class EcdsaVerificationCircuit:
    """Built circuit proving knowledge of a valid (constant) ECDSA triple —
    the shape of the reference demo binary."""

    data: object

    def prove(self, **prove_options):
        return self.data.prove(PartialWitness(), **prove_options)

    def check(self):
        return self.data.check_witness(PartialWitness())

    def verify(self, proof) -> None:
        self.data.verify(proof)


def make_ecdsa_verification_circuit(msg: int, sig: tuple[int, int],
                                    public_key: tuple[int, int],
                                    config: CircuitConfig | None = None,
                                    n_bits: int = 256,
                                    device=None) -> EcdsaVerificationCircuit:
    """``device=None`` builds (and later proves) on the CUDA device and
    raises when there is none."""
    builder = CircuitBuilder(config or CircuitConfig.standard_recursion_config(), device)
    verify_message_circuit(builder, msg, sig[0], sig[1], public_key, n_bits=n_bits)
    return EcdsaVerificationCircuit(data=builder.build())
