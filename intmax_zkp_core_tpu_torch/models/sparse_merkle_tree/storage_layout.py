"""Solidity-style storage layout over SMTs (reference
``src/sparse_merkle_tree/storage_layout/``): value / u128 / bytes16 /
vector / mapping / bytes slots mapped onto SMT positions combined via
Poseidon (no keccak).

Position derivations (``storage_layout/tree.rs:230-257``):
* ``index_position = hash(position) + index``  (multi-limb add with carry,
  overflow allowed);
* ``key_position = hash(key || position)``.

The reference implementation carries a few visible bugs (inverted
bounds checks at ``tree.rs:59-61,153-156``, a ``while == 0`` read loop at
``tree.rs:186``); this rebuild implements the documented semantics
(``storage_layout/mod.rs:1-18``) and keeps the position derivations exact.
"""

from __future__ import annotations

from ...utils.hash_out import HashOut
from ...utils.poseidon_host import hash_no_pad

P = 0xFFFFFFFF00000001


def _add_to_position(digest: HashOut, additive: int) -> HashOut:
    """Multi-limb little-endian addition with carries mod p per limb
    (overflow beyond limb 3 is discarded, as in the reference)."""
    elements = list(digest.elements)
    for i in range(4):
        if additive == 0:
            break
        quotient, remainder = divmod(additive, P)
        room = P - elements[i]
        if remainder < room:
            elements[i] += remainder
            additive = quotient
        else:
            elements[i] = remainder - room
            additive = quotient + 1  # carry
    return HashOut(tuple(elements))


def get_index_position(position: HashOut, index: int) -> HashOut:
    """index_position = hash(position) + index."""
    return _add_to_position(hash_no_pad(list(position.elements)), index)


def get_key_position(position: HashOut, key: HashOut) -> HashOut:
    """key_position = hash(key || position)."""
    return hash_no_pad(list(key.elements) + list(position.elements))


class StorageLayout:
    """Layout over a tree-like object exposing ``set(*keys, value)`` and
    ``find(*keys)``; ``prefix`` supplies the upper-layer keys for the
    layered variants ((contract_address,) for 2-level, two keys for
    3-level — reference ``storage_layout/layered_tree.rs:29``)."""

    def __init__(self, tree, prefix: tuple = ()):
        self.tree = tree
        self.prefix = tuple(prefix)

    def _set(self, position: HashOut, value: HashOut):
        return [self.tree.set(*self.prefix, position, value)]

    def _find(self, position: HashOut):
        res = self.tree.find(*self.prefix, position)
        if isinstance(res, tuple):
            last = res[-1]
            return (last.value if last.found else HashOut.ZERO), list(res)
        return (res.value if res.found else HashOut.ZERO), [res]

    # --- value / u128 / bytes16 ---

    def write_value(self, position: HashOut, value: HashOut):
        return self._set(position, value)

    def read_value(self, position: HashOut):
        return self._find(position)

    def write_u128(self, position: HashOut, value: int):
        return self.write_value(position, HashOut.from_u128(value))

    def read_u128(self, position: HashOut):
        v, proofs = self.read_value(position)
        return v.to_u128(), proofs

    def write_bytes16(self, position: HashOut, value: bytes):
        assert len(value) == 16
        return self.write_u128(position, int.from_bytes(value, "little"))

    def read_bytes16(self, position: HashOut):
        v, proofs = self.read_u128(position)
        return v.to_bytes(16, "little"), proofs

    # --- vector ---

    def write_vector_value(self, position: HashOut, index: int, value: HashOut):
        length, _ = self.read_u128(position)
        if index >= length:
            raise IndexError("out of index")
        return self.write_value(get_index_position(position, index), value)

    def read_vector_value(self, position: HashOut, index: int):
        length, proofs = self.read_u128(position)
        if index >= length:
            raise IndexError("out of index")
        v, proof = self.read_value(get_index_position(position, index))
        return v, proofs + proof

    def push_vector_value(self, position: HashOut, value: HashOut):
        length, _ = self.read_u128(position)
        proofs = self.write_u128(position, length + 1)
        proofs += self.write_value(get_index_position(position, length), value)
        return proofs

    # --- mapping ---

    def write_mapping_value(self, position: HashOut, key: HashOut, value: HashOut):
        return self.write_value(get_key_position(position, key), value)

    def read_mapping_value(self, position: HashOut, key: HashOut):
        return self.read_value(get_key_position(position, key))

    # --- bytes ---

    def write_bytes_data(self, position: HashOut, value: bytes):
        proofs = self.write_u128(position, len(value))
        for i in range(0, len(value), 16):
            chunk = value[i : i + 16].ljust(16, b"\x00")
            proofs += self.write_bytes16(get_index_position(position, i // 16), chunk)
        return proofs

    def read_bytes_data(self, position: HashOut):
        length, proofs = self.read_u128(position)
        out = b""
        index = 0
        remaining = length
        while remaining > 0:
            chunk, proof = self.read_bytes16(get_index_position(position, index))
            take = min(remaining, 16)
            out += chunk[:take]
            proofs += proof
            remaining -= take
            index += 1
        return out, proofs
