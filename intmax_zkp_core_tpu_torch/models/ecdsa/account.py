"""secp256k1 accounts (reference ``src/ecdsa/account.rs``, cargo feature
``ecdsa``, off by default — ``Cargo.toml:12,19``).

* ``address = PoseidonHash::hash_pad(pk.x || pk.y)`` with each coordinate
  packed as 5 Goldilocks limbs of 52 bits (``account.rs:24-42``);
* byte codecs for scalars / points / signatures (``account.rs:142-197``).

The in-circuit ECDSA verification demo (reference
``src/ecdsa/bin/ecdsa_verification.rs``, via the plonky2_ecdsa dependency)
lives in ``.circuits`` / ``.gadgets`` (non-native secp256k1 arithmetic on
the engine's ``U32MulAddGate``).
"""

from __future__ import annotations

import hmac
import secrets
from dataclasses import dataclass
from hashlib import sha256

from ...utils.hash_out import HashOut
from ...utils.poseidon_host import hash_pad

# secp256k1 domain parameters
P256 = 0xFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFEFFFFFC2F
N256 = 0xFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFEBAAEDCE6AF48A03BBFD25E8CD0364141
GX = 0x79BE667EF9DCBBAC55A06295CE870B07029BFCDB2DCE28D959F2815B16F81798
GY = 0x483ADA7726A3C4655DA4FBFC0E1108A8FD17B448A68554199C47D08FFB10D4B8


def _inv(a: int, m: int) -> int:
    return pow(a, m - 2, m)


def _point_add(p, q):
    if p is None:
        return q
    if q is None:
        return p
    (x1, y1), (x2, y2) = p, q
    if x1 == x2 and (y1 + y2) % P256 == 0:
        return None
    if p == q:
        lam = (3 * x1 * x1) * _inv(2 * y1, P256) % P256
    else:
        lam = (y2 - y1) * _inv((x2 - x1) % P256, P256) % P256
    x3 = (lam * lam - x1 - x2) % P256
    y3 = (lam * (x1 - x3) - y1) % P256
    return (x3, y3)


def point_mul(k: int, point=(GX, GY)):
    result = None
    addend = point
    while k:
        if k & 1:
            result = _point_add(result, addend)
        addend = _point_add(addend, addend)
        k >>= 1
    return result


def _to_limbs_52(value: int) -> list[int]:
    """Pack a 256-bit value into 5 Goldilocks limbs of 52 bits (LE)."""
    return [(value >> (52 * i)) & ((1 << 52) - 1) for i in range(5)]


@dataclass(frozen=True)
class Account:
    private_key: int
    public_key: tuple[int, int]
    address: HashOut


def public_key_to_address(public_key: tuple[int, int]) -> HashOut:
    x_limbs = _to_limbs_52(public_key[0])
    y_limbs = _to_limbs_52(public_key[1])
    return hash_pad(x_limbs + y_limbs)


def private_key_to_account(private_key: int) -> Account:
    assert 0 < private_key < N256
    public_key = point_mul(private_key)
    return Account(
        private_key=private_key,
        public_key=public_key,
        address=public_key_to_address(public_key),
    )


def rand_account() -> Account:
    return private_key_to_account(1 + secrets.randbelow(N256 - 1))


# --- byte codecs (account.rs:142-197) ---


def pack_scalar(value: int) -> bytes:
    return value.to_bytes(32, "big")


def unpack_scalar(data: bytes) -> int:
    assert len(data) == 32
    return int.from_bytes(data, "big")


def pack_point(point: tuple[int, int]) -> bytes:
    return pack_scalar(point[0]) + pack_scalar(point[1])


def unpack_point(data: bytes) -> tuple[int, int]:
    assert len(data) == 64
    return (unpack_scalar(data[:32]), unpack_scalar(data[32:]))


def pack_signature(sig: tuple[int, int]) -> bytes:
    return pack_scalar(sig[0]) + pack_scalar(sig[1])


def unpack_signature(data: bytes) -> tuple[int, int]:
    assert len(data) == 64
    return (unpack_scalar(data[:32]), unpack_scalar(data[32:]))


# --- host-side sign/verify (RFC6979-style deterministic nonce) ---


def sign_message(private_key: int, msg_hash: int) -> tuple[int, int]:
    h = msg_hash % N256
    k_bytes = hmac.new(
        private_key.to_bytes(32, "big"), h.to_bytes(32, "big"), sha256
    ).digest()
    k = (int.from_bytes(k_bytes, "big") % (N256 - 1)) + 1
    x, _ = point_mul(k)
    r = x % N256
    s = _inv(k, N256) * (h + r * private_key) % N256
    return (r, s)


def verify_message(public_key: tuple[int, int], msg_hash: int, sig: tuple[int, int]) -> bool:
    r, s = sig
    if not (0 < r < N256 and 0 < s < N256):
        return False
    h = msg_hash % N256
    w = _inv(s, N256)
    u1 = h * w % N256
    u2 = r * w % N256
    point = _point_add(point_mul(u1), point_mul(u2, public_key))
    if point is None:
        return False
    return point[0] % N256 == r


def verify_message_circuit(builder, msg, sig_r, sig_s, public_key, n_bits: int = 256):
    """In-circuit ECDSA verification (reference
    ``ecdsa/bin/ecdsa_verification.rs:52``); see ``.circuits`` for the
    implementation over the non-native secp256k1 gadget library."""
    from .circuits import verify_message_circuit as _impl

    return _impl(builder, msg, sig_r, sig_s, public_key, n_bits=n_bits)
