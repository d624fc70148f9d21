"""In-circuit ECDSA verification demo (reference
``src/ecdsa/bin/ecdsa_verification.rs:23-60``): make an account, sign a
message, build the verification circuit with the triple installed as
constants, prove, and verify.

Usage: python -m intmax_zkp_core_tpu_torch.bin.ecdsa_verification [n_bits] [--check-only]

``n_bits`` (default 256) trims the scalar-multiplier bit width; lowering
it (e.g. 16, with a contrived small-exponent signature) gives a fast
smoke-test of the same constraint system.  ``--check-only`` validates the
witness against every constraint without the FRI proof.  The circuit is
built and proved on the CUDA device, and the binary raises without one.
"""

from __future__ import annotations

import sys
import time


def demo_triple(n_bits: int = 256):
    """The demo's (msg, sig, public key): at 256 bits an account's signature
    of a fixed message; below, a contrived small-exponent triple whose
    verifier scalars u1, u2 fit ``n_bits``, so the trimmed multiplier stays
    sound (see tests/test_torch_ecdsa.py)."""
    from ..models.ecdsa.account import (
        N256,
        _point_add,
        point_mul,
        private_key_to_account,
        sign_message,
    )

    if n_bits >= 256:
        account = private_key_to_account(0x517EC552_D65F1E58_3FBB2B28_9E315E49)
        msg = 0xA5A5A5A5_DEADBEEF_00C0FFEE_12345678
        return msg, sign_message(account.private_key, msg), account.public_key
    d = 0x5EED5EED5EED5EED5EED5EED5EED5EED
    pk = point_mul(d)
    u1 = 0xA5F3 % (1 << n_bits)
    u2 = 0x3C71 % (1 << n_bits)
    q = _point_add(point_mul(u1), point_mul(u2, pk))
    r = q[0] % N256
    s = r * pow(u2, -1, N256) % N256
    msg = u1 * s % N256
    return msg, (r, s), pk


def main(argv: list[str]) -> None:
    n_bits = 256
    check_only = "--check-only" in argv
    pos = [a for a in argv if not a.startswith("-")]
    if pos:
        n_bits = int(pos[0])

    from ..models.ecdsa.account import verify_message
    from ..models.ecdsa.circuits import make_ecdsa_verification_circuit

    msg, sig, pk = demo_triple(n_bits)
    assert verify_message(pk, msg, sig), "host-side signature check failed"
    print(f"message signed; host verify ok (n_bits={n_bits})")

    t0 = time.time()
    circuit = make_ecdsa_verification_circuit(msg, sig, pk, n_bits=n_bits)
    print(f"circuit built: {time.time() - t0:.1f}s")

    t0 = time.time()
    if check_only:
        circuit.check()
        print(f"witness checked against all constraints: {time.time() - t0:.1f}s")
    else:
        proof = circuit.prove()
        print(f"proved: {time.time() - t0:.1f}s")
        t0 = time.time()
        circuit.verify(proof)
        print(f"verified: {time.time() - t0:.1f}s")


if __name__ == "__main__":
    main(sys.argv[1:])
