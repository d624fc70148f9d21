"""zkDSA accounts: hash-based "signature" keys (reference
``src/zkdsa/account.rs``).

* ``public_key = Poseidon(sk || sk)``; ``address = public_key.elements[0]``
  (``account.rs:164-170``);
* ``Address`` is one field element, hex-serialized as 8 BE bytes
  (``account.rs:63-99``) but packed as 4 limbs (value, 0, 0, 0) in field
  streams (``account.rs:140-155``).
"""

from __future__ import annotations

import secrets
from dataclasses import dataclass

from ...utils.hash_out import HashOut
from ...utils.poseidon_host import two_to_one

P = 0xFFFFFFFF00000001


@dataclass(frozen=True)
class Address:
    value: int

    def __post_init__(self):
        object.__setattr__(self, "value", int(self.value) % P)

    def to_hex(self) -> str:
        return "0x" + self.value.to_bytes(8, "big").hex()

    @classmethod
    def from_hex(cls, s: str) -> "Address":
        assert s.startswith("0x"), f"missing 0x prefix: {s}"
        raw = bytes.fromhex(s[2:] if len(s) % 2 == 0 else "0" + s[2:])
        assert len(raw) <= 8, "too long hexadecimal sequence"
        return cls(int.from_bytes(raw, "big"))

    def to_hash_out(self) -> HashOut:
        return HashOut((self.value, 0, 0, 0))

    @classmethod
    def from_hash_out(cls, h: HashOut) -> "Address":
        assert h.elements[1] == 0 and h.elements[2] == 0 and h.elements[3] == 0
        return cls(h.elements[0])

    def write(self, out: list[int]) -> None:
        out.extend([self.value, 0, 0, 0])

    @classmethod
    def read(cls, it) -> "Address":
        v = next(it)
        for _ in range(3):
            next(it)
        return cls(v)

    @classmethod
    def rand(cls) -> "Address":
        return cls(secrets.randbelow(P))

    def __str__(self) -> str:
        return self.to_hex()


@dataclass(frozen=True)
class Account:
    private_key: HashOut
    public_key: HashOut
    address: Address

    @classmethod
    def new(cls, private_key: HashOut) -> "Account":
        return private_key_to_account(private_key)

    @classmethod
    def rand(cls) -> "Account":
        return cls.new(HashOut.rand())

    def to_json(self) -> dict:
        return {
            "private_key": self.private_key.to_hex(),
            "public_key": self.public_key.to_hex(),
            "address": self.address.to_hex(),
        }

    @classmethod
    def from_json(cls, o: dict) -> "Account":
        return cls(
            private_key=HashOut.from_hex(o["private_key"]),
            public_key=HashOut.from_hex(o["public_key"]),
            address=Address.from_hex(o["address"]),
        )


def private_key_to_public_key(private_key: HashOut) -> HashOut:
    return two_to_one(private_key, private_key)


def public_key_to_address(public_key: HashOut) -> Address:
    return Address(public_key.elements[0])


def private_key_to_account(private_key: HashOut) -> Account:
    public_key = private_key_to_public_key(private_key)
    return Account(
        private_key=private_key,
        public_key=public_key,
        address=public_key_to_address(public_key),
    )
