"""4-limb Goldilocks digests with the reference's hex/packing codecs.

Mirrors ``WrappedHashOut<F>`` (reference
``src/sparse_merkle_tree/goldilocks_poseidon/hash/mod.rs:16-370``):

* a digest is 4 canonical Goldilocks elements;
* hex form is the 32 little-endian bytes (element 0 first, each element as
  8 LE bytes) reversed to big-endian, 0x-prefixed — 66 chars;
* ``from_u32/u64/u128/i128`` pack 4 LE bytes per element (diagram at
  reference ``hash/mod.rs:246-267``).

Host-side digests are plain tuples of Python ints (exact, hashable); arrays
enter only in the batched device kernels.
"""

from __future__ import annotations

import secrets
from dataclasses import dataclass

P = 0xFFFFFFFF00000001

ZERO_ELEMENTS = (0, 0, 0, 0)


@dataclass(frozen=True)
class HashOut:
    elements: tuple[int, int, int, int]

    ZERO: "HashOut" = None  # set below

    def __post_init__(self):
        assert len(self.elements) == 4
        object.__setattr__(self, "elements", tuple(int(e) % P for e in self.elements))

    # --- hex codec (Display/FromStr + serde, hash/mod.rs:43-117) ---

    def to_bytes(self) -> bytes:
        """32 little-endian bytes, element 0 first."""
        return b"".join(e.to_bytes(8, "little") for e in self.elements)

    @classmethod
    def from_bytes(cls, data: bytes) -> "HashOut":
        assert len(data) == 32
        return cls(tuple(int.from_bytes(data[8 * i : 8 * i + 8], "little") for i in range(4)))

    def to_hex(self) -> str:
        return "0x" + self.to_bytes()[::-1].hex()

    @classmethod
    def from_hex(cls, s: str) -> "HashOut":
        assert s.startswith("0x"), f"missing 0x prefix: {s}"
        raw = bytes.fromhex(s[2:] if len(s) % 2 == 0 else "0" + s[2:])
        assert len(raw) <= 32, "too long hexadecimal sequence"
        little = raw[::-1] + b"\x00" * (32 - len(raw))
        return cls.from_bytes(little)

    # --- integer packing codecs (hash/mod.rs:178-321) ---

    @classmethod
    def from_u32(cls, value: int) -> "HashOut":
        assert 0 <= value < 1 << 32
        return cls((value, 0, 0, 0))

    def to_u32(self) -> int:
        return self.elements[0] & 0xFFFFFFFF

    @classmethod
    def from_u64(cls, value: int) -> "HashOut":
        assert 0 <= value < 1 << 64
        return cls((value & 0xFFFFFFFF, value >> 32, 0, 0))

    def to_u64(self) -> int:
        return (self.elements[0] & 0xFFFFFFFF) | ((self.elements[1] & 0xFFFFFFFF) << 32)

    @classmethod
    def from_u128(cls, value: int) -> "HashOut":
        assert 0 <= value < 1 << 128
        return cls(tuple((value >> (32 * i)) & 0xFFFFFFFF for i in range(4)))

    def to_u128(self) -> int:
        out = 0
        for i in range(4):
            out |= (self.elements[i] & 0xFFFFFFFF) << (32 * i)
        return out

    @classmethod
    def from_i128(cls, value: int) -> "HashOut":
        return cls.from_u128(value & ((1 << 128) - 1))

    def to_i128(self) -> int:
        v = self.to_u128()
        return v - (1 << 128) if v >> 127 else v

    # --- field-element stream codec (hash/mod.rs:157-171) ---

    def write(self, out: list[int]) -> None:
        out.extend(self.elements)

    @classmethod
    def read(cls, it) -> "HashOut":
        return cls((next(it), next(it), next(it), next(it)))

    @classmethod
    def rand(cls) -> "HashOut":
        return cls(tuple(secrets.randbelow(P) for _ in range(4)))

    def __iter__(self):
        return iter(self.elements)

    def __str__(self) -> str:
        return self.to_hex()

    @property
    def is_zero(self) -> bool:
        return self.elements == ZERO_ELEMENTS


HashOut.ZERO = HashOut(ZERO_ELEMENTS)


# --- secp256k1 <-> Goldilocks limb codec (reference
# ``hash/secp256k1.rs:12-56``, ecdsa feature): pack a 256-bit secp256k1
# base/scalar value into 4 Goldilocks limbs positionally (base p). ---

SECP256K1_SCALAR_ORDER = 0xFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFEBAAEDCE6AF48A03BBFD25E8CD0364141
SECP256K1_BASE_ORDER = 0xFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFEFFFFFC2F


def _from_noncanonical_uint(value: int) -> HashOut:
    elements = []
    for _ in range(4):
        elements.append(value % P)
        value //= P
    return HashOut(tuple(elements))


def _to_canonical_uint(h: HashOut, order: int) -> int:
    result = 0
    power = 1
    for e in h.elements:
        result += e * power
        power *= P
    return result % order


def from_noncanonical_secp256k1_scalar(value: int) -> HashOut:
    return _from_noncanonical_uint(value % SECP256K1_SCALAR_ORDER)


def to_canonical_secp256k1_scalar(h: HashOut) -> int:
    return _to_canonical_uint(h, SECP256K1_SCALAR_ORDER)


def from_noncanonical_secp256k1_base(value: int) -> HashOut:
    return _from_noncanonical_uint(value % SECP256K1_BASE_ORDER)


def to_canonical_secp256k1_base(h: HashOut) -> int:
    return _to_canonical_uint(h, SECP256K1_BASE_ORDER)
