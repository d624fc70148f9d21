"""Small host pieces of the port against the JAX package: the port version of
``test_misc_parity.py``.  The secp256k1 limb codec, the ECDSA account and its
signature, the storage-layout bytes, the token-kind codec, block-header
serde and hash, ``log2_ceil`` and ``make_deposit_proof``; the JAX test's
checks on the port's objects, and on seeded inputs the port's values equal
to the JAX package's.  Tolerance 0."""

import random

import pytest

from intmax_zkp_core_tpu.models.rollup import deposit as jdeposit
from intmax_zkp_core_tpu.models.rollup.gadgets import deposit_block as jdb
from intmax_zkp_core_tpu.models.sparse_merkle_tree import SparseMerkleTree as JSparseMerkleTree
from intmax_zkp_core_tpu.models.sparse_merkle_tree import storage_layout as jlayout
from intmax_zkp_core_tpu.models.transaction import block_header as jheader
from intmax_zkp_core_tpu.models.zkdsa.account import Address as JAddress
from intmax_zkp_core_tpu.utils import hash_out as jhash
from intmax_zkp_core_tpu_torch.models.ecdsa.account import (
    pack_signature,
    private_key_to_account as ecdsa_account,
    public_key_to_address,
    sign_message,
    unpack_signature,
    verify_message,
)
from intmax_zkp_core_tpu_torch.models.merkle_tree.tree import get_merkle_root, log2_ceil
from intmax_zkp_core_tpu_torch.models.rollup.deposit import make_deposit_proof
from intmax_zkp_core_tpu_torch.models.rollup.gadgets.deposit_block import DepositInfo, VariableIndex
from intmax_zkp_core_tpu_torch.models.sparse_merkle_tree import SparseMerkleTree
from intmax_zkp_core_tpu_torch.models.sparse_merkle_tree.storage_layout import (
    StorageLayout,
    get_index_position,
    get_key_position,
)
from intmax_zkp_core_tpu_torch.models.transaction.asset import ContributedAsset, TokenKind
from intmax_zkp_core_tpu_torch.models.transaction.block_header import BlockHeader, get_block_hash
from intmax_zkp_core_tpu_torch.models.zkdsa.account import Address
from intmax_zkp_core_tpu_torch.utils import hash_out as thash
from intmax_zkp_core_tpu_torch.utils.hash_out import HashOut
from intmax_zkp_core_tpu_torch.utils.poseidon_host import two_to_one

P = 0xFFFFFFFF00000001


def _seeded_hash(rng):
    return tuple(rng.randrange(P) for _ in range(4))


@pytest.mark.parametrize("kind", ["scalar", "base"])
def test_secp256k1_limb_codec(kind):
    # hash/secp256k1.rs:72-102 canonicity properties
    order = thash.SECP256K1_SCALAR_ORDER if kind == "scalar" else thash.SECP256K1_BASE_ORDER
    to_port = getattr(thash, f"from_noncanonical_secp256k1_{kind}")
    from_port = getattr(thash, f"to_canonical_secp256k1_{kind}")
    to_jax = getattr(jhash, f"from_noncanonical_secp256k1_{kind}")
    from_jax = getattr(jhash, f"to_canonical_secp256k1_{kind}")
    rng = random.Random(11)
    h = HashOut(_seeded_hash(rng))
    assert to_port(from_port(h)) == h
    assert from_port(h) == from_jax(jhash.HashOut(h.elements))
    for value in (0, 1, order - 1, order, order + 5, rng.getrandbits(256)):
        assert to_port(value).elements == to_jax(value).elements
    # NEG_ONE is noncanonical after the round trip (4 Goldilocks limbs < the order)
    assert from_port(to_port(order - 1)) != order - 1


def test_ecdsa_account_and_signature():
    acct = ecdsa_account(987654321)
    sig = sign_message(acct.private_key, 0xDEADBEEF)
    assert verify_message(acct.public_key, 0xDEADBEEF, sig)
    assert not verify_message(acct.public_key, 0xDEADBEF0, sig)
    assert unpack_signature(pack_signature(sig)) == sig
    assert public_key_to_address(acct.public_key) == acct.address
    # the in-circuit verifier is there (test_torch_ecdsa.py covers it)
    from intmax_zkp_core_tpu_torch.models.ecdsa.account import verify_message_circuit
    from intmax_zkp_core_tpu_torch.models.ecdsa.circuits import (
        verify_message_circuit as in_circuit,
    )

    assert callable(in_circuit) and callable(verify_message_circuit)


def _layout_ops(layout, hash_cls):
    """The JAX test's storage-layout operations, on either package; returns
    every value read and the final root."""
    out = []
    pos = hash_cls.from_u32(5)
    layout.write_u128(pos, 123456789012345678901234567890)
    v, proofs = layout.read_u128(pos)
    out += [v, proofs[0].found]
    pos2 = hash_cls.from_u32(9)
    layout.push_vector_value(pos2, hash_cls.from_u32(11))
    layout.push_vector_value(pos2, hash_cls.from_u32(22))
    out.append(layout.read_vector_value(pos2, 1)[0].elements)
    with pytest.raises(IndexError):
        layout.read_vector_value(pos2, 2)
    key = hash_cls.from_u32(77)
    layout.write_mapping_value(pos, key, hash_cls.from_u32(99))
    out.append(layout.read_mapping_value(pos, key)[0].elements)
    out.append(layout.read_u128(pos)[0])
    data = b"hello storage layout bytes data!!" * 2
    bpos = hash_cls.from_u32(1234)
    layout.write_bytes_data(bpos, data)
    out.append(layout.read_bytes_data(bpos)[0])
    return out, layout.tree.get_root().elements


def test_storage_layout_value_vector_mapping_bytes():
    got, root = _layout_ops(StorageLayout(SparseMerkleTree()), HashOut)
    assert got[:2] == [123456789012345678901234567890, True]
    assert got[2] == HashOut.from_u32(22).elements and got[3] == HashOut.from_u32(99).elements
    # the mapping slot is position-derived and does not clobber the value slot
    assert got[4] == 123456789012345678901234567890
    assert got[5] == b"hello storage layout bytes data!!" * 2
    want, jroot = _layout_ops(jlayout.StorageLayout(JSparseMerkleTree()), jhash.HashOut)
    assert got == want and root == jroot
    pos, key = HashOut.from_u32(5), HashOut.from_u32(77)
    # position derivations are hash-based and distinct, and the JAX package's
    assert get_index_position(pos, 0) != get_index_position(pos, 1)
    assert get_key_position(pos, key) != get_key_position(key, pos)
    assert get_key_position(pos, key).elements == jlayout.get_key_position(
        jhash.HashOut.from_u32(5), jhash.HashOut.from_u32(77)).elements
    assert get_index_position(pos, 3).elements == jlayout.get_index_position(
        jhash.HashOut.from_u32(5), 3).elements


def test_token_kind_bytes_codec():
    kind = TokenKind(contract_address=Address(123456), variable_index=VariableIndex(7))
    assert TokenKind.from_bytes(kind.to_bytes()) == kind
    from intmax_zkp_core_tpu.models.transaction.asset import TokenKind as JTokenKind

    assert kind.to_bytes() == JTokenKind(contract_address=JAddress(123456),
                                         variable_index=jdb.VariableIndex(7)).to_bytes()
    asset = ContributedAsset(receiver_address=Address(5), kind=kind, amount=10)
    assert ContributedAsset.from_deposit_info(asset.to_deposit_info()) == asset
    assert ContributedAsset.from_json(asset.to_json()) == asset


def _header(header_cls, hash_cls):
    return header_cls(
        block_number=0,
        prev_block_hash=hash_cls.from_u32(1),
        block_headers_digest=hash_cls.from_u32(2),
        transactions_digest=hash_cls.from_u32(3),
        deposit_digest=hash_cls.from_u32(4),
        proposed_world_state_digest=hash_cls.from_u32(5),
        approved_world_state_digest=hash_cls.from_u32(6),
        latest_account_digest=hash_cls.from_u32(7),
    )


def test_block_header_serde_and_hash():
    h = _header(BlockHeader, HashOut)
    j = h.to_json()
    # block_header.rs:104-124 format: 0x-prefixed BE u32 block number
    assert j["block_number"] == "0x00000000"
    assert BlockHeader.from_json(j) == h
    assert get_block_hash(h) != HashOut.ZERO
    jh = _header(jheader.BlockHeader, jhash.HashOut)
    assert j == jh.to_json()
    assert get_block_hash(h).elements == jheader.get_block_hash(jh).elements
    assert log2_ceil(6) == 3 and log2_ceil(1) == 0 and log2_ceil(8) == 3


def test_make_deposit_proof():
    # rollup/deposit.rs:46-135: 3 bridge trees, roots combined with chain
    # indices, dense + SMT inclusion proof pairs for a receiver
    receiver = Address(42)
    deposits = [DepositInfo(receiver_address=receiver, contract_address=Address(1),
                            variable_index=VariableIndex(0), amount=5)]
    proofs = make_deposit_proof(deposits, [], [], receiver, num_log_txs=2)
    assert len(proofs) == 3
    dense0, smt0 = proofs[0]
    # the deposit bridge contains the receiver; empty bridges do not
    assert smt0.found
    assert not proofs[1][1].found
    # the dense proof folds to the combined root
    assert get_merkle_root(dense0.index, dense0.value, dense0.siblings) == dense0.root
    # leaf 0 = Poseidon(deposit_tree_root || chain_index 0)
    assert dense0.value == two_to_one(smt0.root, HashOut.ZERO)
    jproofs = jdeposit.make_deposit_proof(
        [jdb.DepositInfo(receiver_address=JAddress(42), contract_address=JAddress(1),
                         variable_index=jdb.VariableIndex(0), amount=5)],
        [], [], JAddress(42), num_log_txs=2)
    for (dense, smt), (jdense, jsmt) in zip(proofs, jproofs):
        assert dense.root.elements == jdense.root.elements
        assert dense.value.elements == jdense.value.elements
        assert [s.elements for s in dense.siblings] == [s.elements for s in jdense.siblings]
        assert smt.to_json() == jsmt.to_json()
