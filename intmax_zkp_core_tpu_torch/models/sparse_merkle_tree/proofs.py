"""SMT proof objects and the circomlib re-verification state machine.

Reference: ``src/sparse_merkle_tree/proof/{process,inclusion,common}.rs``.
The process-proof verifier replays circomlib's ``smtprocessorsm`` /
``smtlevins`` circuits out-of-circuit; the in-circuit gadget
(``models/sparse_merkle_tree/gadgets/process.py``) emits the same logic as
constraints.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from enum import Enum

from ...utils.hash_out import HashOut
from .node_data import Node, calc_node_hash


class ProcessMerkleProofRole(Enum):
    """noop/update/insert/delete <-> [bool;2]/u8 codecs
    (``proof/process.rs:54-131``)."""

    ProcessNoOp = 0
    ProcessUpdate = 1
    ProcessInsert = 2
    ProcessDelete = 3

    def to_bools(self) -> tuple[bool, bool]:
        return {
            ProcessMerkleProofRole.ProcessNoOp: (False, False),
            ProcessMerkleProofRole.ProcessUpdate: (False, True),
            ProcessMerkleProofRole.ProcessInsert: (True, False),
            ProcessMerkleProofRole.ProcessDelete: (True, True),
        }[self]

    @classmethod
    def from_bools(cls, bits) -> "ProcessMerkleProofRole":
        return {
            (False, False): cls.ProcessNoOp,
            (False, True): cls.ProcessUpdate,
            (True, False): cls.ProcessInsert,
            (True, True): cls.ProcessDelete,
        }[tuple(bool(b) for b in bits)]

    def to_u8(self) -> int:
        return self.value

    @classmethod
    def from_u8(cls, v: int) -> "ProcessMerkleProofRole":
        return cls(v)


@dataclass
class SparseMerkleInclusionProof:
    """(non-)inclusion witness (``proof/inclusion.rs:6-33``)."""

    root: HashOut
    found: bool
    key: HashOut
    value: HashOut
    not_found_key: HashOut
    not_found_value: HashOut
    siblings: list[HashOut]
    is_old0: bool

    @classmethod
    def with_root(cls, root: HashOut) -> "SparseMerkleInclusionProof":
        """Default no-op inclusion proof of the empty key in `root`."""
        return cls(
            root=root,
            found=False,
            key=HashOut.ZERO,
            value=HashOut.ZERO,
            not_found_key=HashOut.ZERO,
            not_found_value=HashOut.ZERO,
            siblings=[],
            is_old0=True,
        )

    def to_json(self) -> dict:
        """Reference serde layout: serde-derive field names (snake_case),
        hex digests (``proof/inclusion.rs:5-33``)."""
        return {
            "root": self.root.to_hex(),
            "found": self.found,
            "key": self.key.to_hex(),
            "value": self.value.to_hex(),
            "not_found_key": self.not_found_key.to_hex(),
            "not_found_value": self.not_found_value.to_hex(),
            "siblings": [s.to_hex() for s in self.siblings],
            "is_old0": self.is_old0,
        }

    @classmethod
    def from_json(cls, o: dict) -> "SparseMerkleInclusionProof":
        return cls(
            root=HashOut.from_hex(o["root"]),
            found=o["found"],
            key=HashOut.from_hex(o["key"]),
            value=HashOut.from_hex(o["value"]),
            not_found_key=HashOut.from_hex(o["not_found_key"]),
            not_found_value=HashOut.from_hex(o["not_found_value"]),
            siblings=[HashOut.from_hex(s) for s in o["siblings"]],
            is_old0=o["is_old0"],
        )


@dataclass
class SparseMerkleProcessProof:
    """State-transition witness for one SMT op (``proof/process.rs:12-51``)."""

    old_root: HashOut
    old_key: HashOut
    old_value: HashOut
    new_root: HashOut
    new_key: HashOut
    new_value: HashOut
    siblings: list[HashOut]
    is_old0: bool
    fnc: ProcessMerkleProofRole

    @classmethod
    def with_root(cls, root: HashOut) -> "SparseMerkleProcessProof":
        return cls(
            old_root=root,
            old_key=HashOut.ZERO,
            old_value=HashOut.ZERO,
            new_root=root,
            new_key=HashOut.ZERO,
            new_value=HashOut.ZERO,
            siblings=[],
            is_old0=True,
            fnc=ProcessMerkleProofRole.ProcessNoOp,
        )

    def check(self) -> None:
        verify_smt_process_proof(self)

    def to_json(self) -> dict:
        """Reference serde layout: snake_case field names, ``fnc`` as the
        enum variant-name string (serde's unit-variant default —
        ``proof/process.rs:12-22,53-59``)."""
        return {
            "old_root": self.old_root.to_hex(),
            "old_key": self.old_key.to_hex(),
            "old_value": self.old_value.to_hex(),
            "new_root": self.new_root.to_hex(),
            "new_key": self.new_key.to_hex(),
            "new_value": self.new_value.to_hex(),
            "siblings": [s.to_hex() for s in self.siblings],
            "is_old0": self.is_old0,
            "fnc": self.fnc.name,
        }

    @classmethod
    def from_json(cls, o: dict) -> "SparseMerkleProcessProof":
        fnc = o["fnc"]
        return cls(
            old_root=HashOut.from_hex(o["old_root"]),
            old_key=HashOut.from_hex(o["old_key"]),
            old_value=HashOut.from_hex(o["old_value"]),
            new_root=HashOut.from_hex(o["new_root"]),
            new_key=HashOut.from_hex(o["new_key"]),
            new_value=HashOut.from_hex(o["new_value"]),
            siblings=[HashOut.from_hex(s) for s in o["siblings"]],
            is_old0=o["is_old0"],
            fnc=ProcessMerkleProofRole[fnc]
            if isinstance(fnc, str)
            else ProcessMerkleProofRole.from_u8(fnc),
        )


# ---------------------------------------------------------------------------
# circomlib state-machine re-verification (proof/process.rs:153-370,
# proof/common.rs:8-44)
# ---------------------------------------------------------------------------

# ProcessorStatus
TOP, BOTTOM, OLD0, NEW1, UPD, NA = "top", "bot", "old0", "new1", "upd", "na"


def key_to_bits_256(key: HashOut) -> list[bool]:
    """LE bit path of a digest key: 4 elements x 64 LE bits
    (``goldilocks_poseidon/mod.rs:27-48``)."""
    bits = []
    for e in key.elements:
        for i in range(64):
            bits.append(bool((e >> i) & 1))
    return bits


def first_different_bit_index(old_key: HashOut, new_key: HashOut) -> int | None:
    """``proof/common.rs:86-99``."""
    a = key_to_bits_256(old_key)
    b = key_to_bits_256(new_key)
    for i, (x, y) in enumerate(zip(a, b)):
        if x != y:
            return i
    return None


def smt_lev_ins(siblings: list[HashOut], enabled: bool) -> list[bool]:
    """levIns[i] = this level and all deeper have zero siblings, parent has a
    non-zero one (``proof/common.rs:8-44``; circomlib smtlevins)."""
    is_zeros = [s.is_zero for s in siblings]
    if enabled:
        assert is_zeros[-1], "the last level must have a zero sibling"
    is_zeros.reverse()
    is_zeros.append(False)

    lev_ins = []
    last_done = False
    for i in range(len(siblings)):
        lev_ins.append(not is_zeros[i + 1] and not last_done)
        last_done = last_done or not is_zeros[i + 1]
    lev_ins.reverse()
    return lev_ins


def smt_processor_sm(
    prev: str,
    is_different_bit: bool,
    is_old0: bool,
    is_inserting_level: bool,
    is_insert_or_remove_op: bool,
) -> str:
    """circomlib smtprocessorsm transition (``proof/process.rs:340-370``)."""
    if prev == TOP:
        if not is_inserting_level:
            return TOP
        if not is_insert_or_remove_op:
            return UPD
        if is_old0:
            return OLD0
        if is_different_bit:
            return NEW1
        return BOTTOM
    if prev == BOTTOM:
        return NEW1 if is_different_bit else BOTTOM
    return NA


def calc_old_new_root(
    old_kv: tuple[HashOut, HashOut],
    new_kv: tuple[HashOut, HashOut],
    siblings: list[HashOut],
    n2b_new: list[bool],
    sm: list[str],
    num_levels: int,
) -> tuple[HashOut, HashOut]:
    """Root reconstruction per level (``proof/process.rs:260-337``)."""
    zero = HashOut.ZERO
    old1_leaf = calc_node_hash(Node.leaf(*old_kv))
    new1_leaf = calc_node_hash(Node.leaf(*new_kv))
    old_child, new_child = zero, zero
    for i in reversed(range(num_levels)):
        bit = n2b_new[i]
        st = sm[i]
        if bit:
            old_hash = calc_node_hash(Node.internal(siblings[i], old_child))
        else:
            old_hash = calc_node_hash(Node.internal(old_child, siblings[i]))

        old_root = {TOP: old_hash, BOTTOM: old1_leaf, NEW1: old1_leaf, UPD: old1_leaf}.get(st, zero)

        new_left = {TOP: new_child, BOTTOM: new_child, NEW1: new1_leaf}.get(st, zero)
        new_right = {TOP: siblings[i], NEW1: old1_leaf}.get(st, zero)
        if bit:
            new_hash = calc_node_hash(Node.internal(new_right, new_left))
        else:
            new_hash = calc_node_hash(Node.internal(new_left, new_right))

        new_root = {TOP: new_hash, BOTTOM: new_hash, NEW1: new_hash, OLD0: new1_leaf, UPD: new1_leaf}.get(st, zero)

        old_child, new_child = old_root, new_root
    return old_child, new_child


def verify_smt_process_proof(proof: SparseMerkleProcessProof) -> None:
    """Out-of-circuit replay of circomlib's smtprocessor
    (``proof/process.rs:153-257``); raises AssertionError on invalid proofs.

    Core circomlib trick preserved: a delete proof is verified by swapping
    old/new and checking it as an insert (``proof/process.rs:163-186``).
    """
    enabled = proof.fnc != ProcessMerkleProofRole.ProcessNoOp

    if proof.fnc == ProcessMerkleProofRole.ProcessDelete:
        fnc = ProcessMerkleProofRole.ProcessInsert
        old_key, old_value, old_root = proof.new_key, proof.new_value, proof.new_root
        new_key, new_value, new_root = proof.old_key, proof.old_value, proof.old_root
    else:
        fnc = proof.fnc
        old_key, old_value, old_root = proof.old_key, proof.old_value, proof.old_root
        new_key, new_value, new_root = proof.new_key, proof.new_value, proof.new_root

    n2b_old = key_to_bits_256(old_key)
    n2b_new = key_to_bits_256(new_key)

    siblings = list(proof.siblings)
    assert len(siblings) < len(n2b_new), "siblings longer than the Merkle path"
    siblings += [HashOut.ZERO] * (len(n2b_new) - len(siblings))
    lev_ins = smt_lev_ins(siblings, enabled)

    prev = TOP if enabled else NA
    is_insert_or_remove_op = fnc == ProcessMerkleProofRole.ProcessInsert
    sm = []
    for i in range(len(lev_ins)):
        st = smt_processor_sm(
            prev, n2b_old[i] != n2b_new[i], proof.is_old0, lev_ins[i], is_insert_or_remove_op
        )
        sm.append(st)
        prev = st

    assert sm[-1] not in (TOP, BOTTOM), "the last status must not be top/bottom"

    num_levels = len(n2b_new)
    top_old, top_new = calc_old_new_root(
        (old_key, old_value), (new_key, new_value), siblings, n2b_new, sm, num_levels
    )

    if enabled:
        assert top_old == old_root, "old root mismatch"
        assert top_new == new_root, "new root mismatch"
    else:
        assert old_root == new_root, "noop must preserve the root"
        assert old_value == new_value, "noop must preserve the value"
    if fnc == ProcessMerkleProofRole.ProcessUpdate or not enabled:
        assert old_key == new_key, "update/noop must preserve the key"
