"""The Rust reference's literals held against the port's objects: the port
version of ``test_reference_literals.py``.

The reference's inline ``#[test]`` functions hard-code digests, hex
serializations and JSON strings that its own implementation produced; the
JAX package's test holds its objects against them, and this file holds the
port's (``intmax_zkp_core_tpu_torch``) against the same literals, test for
test: the default zkDSA public key (``DEFAULT_PK``), the hex and JSON forms
of addresses, hashes, proofs, assets, deposits and block headers, and the
three default-tree digests of ``BlockHeader::new(4)``.  The byte-exact
default ``BlockDetail`` JSON (the reference's literal at
``src/rollup/circuits/mod.rs:93-109``) is held against the JAX package's
serialization of the same object, which its own test holds against that
literal, and its header digests against the cited literals above.
"""

import json

from intmax_zkp_core_tpu.models.rollup.circuits import BlockDetail as JBlockDetail
from intmax_zkp_core_tpu_torch.models.rollup.circuits import BlockDetail
from intmax_zkp_core_tpu_torch.models.rollup.gadgets.deposit_block import (
    DepositInfo,
    VariableIndex,
)
from intmax_zkp_core_tpu_torch.models.sparse_merkle_tree.proofs import (
    SparseMerkleInclusionProof,
    key_to_bits_256,
)
from intmax_zkp_core_tpu_torch.models.transaction.asset import ContributedAsset, TokenKind
from intmax_zkp_core_tpu_torch.models.transaction.block_header import BlockHeader
from intmax_zkp_core_tpu_torch.models.zkdsa.account import Account, Address
from intmax_zkp_core_tpu_torch.models.zkdsa.circuits import SimpleSignaturePublicInputs
from intmax_zkp_core_tpu_torch.utils.hash_out import HashOut

# The Poseidon(0^8) digest the reference hard-codes as the default
# public key / signature (src/zkdsa/circuits/mod.rs:85-101).
DEFAULT_PK = (
    4330397376401421145,
    14124799381142128323,
    8742572140681234676,
    14345658006221440202,
)
DEFAULT_PK_HEX = "0xc71603f33a1144ca7953db0ab48808f4c4055e3364a246c33c18a9786cb0b359"

# BlockHeader::new(4) digests from the golden BlockDetail JSON
# (src/rollup/circuits/mod.rs:104): each is a tree of Rust-computed
# Poseidon evaluations over default leaves.
DEFAULT_BLOCK_HEADERS_DIGEST = (
    "0xd65af5933a094e8329332a714327ba72b1e4dac93c0cde8ee479b9bb36c3fc43"
)
DEFAULT_TRANSACTIONS_DIGEST_D4 = (
    "0xd0053597686f6672b77e23f0fc59019786ac9b34bd97d439e9e6b5c8d15b61ae"
)
DEFAULT_DEPOSIT_DIGEST_D4 = (
    "0xf522eaa0af88a040167d7cf3bf854d278cc1b30d2e2c09475154921a06462644"
)


def test_default_simple_signature():
    """src/zkdsa/circuits/mod.rs:77-106."""
    d = SimpleSignaturePublicInputs.default()
    assert d.message == HashOut.ZERO
    assert d.public_key.elements == DEFAULT_PK
    assert d.signature.elements == DEFAULT_PK


def test_serde_simple_signature_public_inputs():
    """src/zkdsa/circuits/mod.rs:136-153 (Serializable form literal)."""
    d = SimpleSignaturePublicInputs.default()
    assert d.to_json() == {
        "message": "0x" + "0" * 64,
        "public_key": DEFAULT_PK_HEX,
        "signature": DEFAULT_PK_HEX,
    }


def test_fmt_and_serialize_address():
    """src/zkdsa/account.rs:45-58,101-116."""
    value = Address(1)
    assert str(value) == "0x0000000000000001"
    assert Address.from_hex("0x01") == value
    r = Address.rand()
    encoded = str(r)
    assert len(encoded) == 18
    assert Address.from_hex(encoded) == r
    # serde form: the same hex inside JSON quotes
    assert json.dumps(value.to_hex()) == '"0x0000000000000001"'
    assert len(json.dumps(r.to_hex())) == 20


def test_serde_account_roundtrip():
    """src/zkdsa/account.rs:222-228."""
    account = Account.rand()
    assert Account.from_json(json.loads(json.dumps(account.to_json()))) == account


def test_fmt_goldilocks_hashout():
    """src/sparse_merkle_tree/goldilocks_poseidon/hash/mod.rs:63-79."""
    value = HashOut.from_u32(1)
    assert value.to_hex() == "0x" + "0" * 63 + "1"
    assert HashOut.from_hex("0x01") == value
    r = HashOut.rand()
    assert len(r.to_hex()) == 66
    assert HashOut.from_hex(r.to_hex()) == r


def test_serde_goldilocks_hashout():
    """src/sparse_merkle_tree/goldilocks_poseidon/hash/mod.rs:121-138."""
    value = HashOut.from_u32(1)
    assert json.dumps(value.to_hex()) == '"0x' + "0" * 63 + '1"'
    r = HashOut.rand()
    assert len(json.dumps(r.to_hex())) == 68


def test_to_le_bits():
    """src/sparse_merkle_tree/proof/common.rs:60-83: LE bit paths of the
    key digits (our ``key_to_bits_256`` covers the same decomposition)."""
    for v, bits in [
        (1, [True] + [False] * 7),
        (2, [False, True] + [False] * 6),
        (3, [True, True] + [False] * 6),
        (8, [False, False, False, True] + [False] * 4),
    ]:
        assert key_to_bits_256(HashOut.from_u32(v))[:8] == bits


def test_serialize_inclusion_proof():
    """src/sparse_merkle_tree/proof/inclusion.rs:63-81."""
    proof = SparseMerkleInclusionProof(
        root=HashOut.from_u32(1),
        found=True,
        key=HashOut.from_u32(2),
        value=HashOut.from_u32(3),
        not_found_key=HashOut.from_u32(5),
        not_found_value=HashOut.from_u32(6),
        siblings=[HashOut.from_u32(4)],
        is_old0=False,
    )
    o = json.loads(json.dumps(proof.to_json()))
    assert SparseMerkleInclusionProof.from_json(o) == proof


def test_serde_owned_asset():
    """src/transaction/asset.rs:162-190: ContributedAsset round-trip and
    DepositInfo JSON compatibility."""
    owned = ContributedAsset(
        receiver_address=Address.rand(),
        kind=TokenKind(contract_address=Address.rand(), variable_index=VariableIndex(1)),
        amount=10,
    )
    o = json.loads(json.dumps(owned.to_json()))
    assert ContributedAsset.from_json(o) == owned
    # the same JSON decodes as a DepositInfo (interconvertible structs)
    assert DepositInfo.from_json(o) == owned.to_deposit_info()


def test_serde_block_header_literal():
    """src/transaction/block_header.rs:104-124 (exact JSON string)."""
    header = BlockHeader(
        block_number=0,
        prev_block_hash=HashOut.from_u32(1),
        block_headers_digest=HashOut.from_u32(2),
        transactions_digest=HashOut.from_u32(3),
        deposit_digest=HashOut.from_u32(4),
        proposed_world_state_digest=HashOut.from_u32(5),
        approved_world_state_digest=HashOut.from_u32(6),
        latest_account_digest=HashOut.from_u32(7),
    )
    expected = (
        '{"block_number":"0x00000000",'
        '"prev_block_hash":"0x' + "0" * 63 + '1",'
        '"block_headers_digest":"0x' + "0" * 63 + '2",'
        '"transactions_digest":"0x' + "0" * 63 + '3",'
        '"deposit_digest":"0x' + "0" * 63 + '4",'
        '"proposed_world_state_digest":"0x' + "0" * 63 + '5",'
        '"approved_world_state_digest":"0x' + "0" * 63 + '6",'
        '"latest_account_digest":"0x' + "0" * 63 + '7"}'
    )
    assert json.dumps(header.to_json(), separators=(",", ":")) == expected
    assert BlockHeader.from_json(json.loads(expected)) == header


def test_fmt_variable_index():
    """src/rollup/gadgets/deposit_block/mod.rs:77-86."""
    v = VariableIndex(20)
    assert v.to_hex() == "0x14"
    assert VariableIndex.from_hex("0x14") == v


def test_serde_deposit_info_default_literal():
    """src/rollup/gadgets/deposit_block/mod.rs:151-164."""
    d = DepositInfo(
        receiver_address=Address(0),
        contract_address=Address(0),
        variable_index=VariableIndex(0),
        amount=0,
    )
    expected = (
        '{"receiver_address":"0x0000000000000000",'
        '"contract_address":"0x0000000000000000",'
        '"variable_index":"0x00","amount":0}'
    )
    assert json.dumps(d.to_json(), separators=(",", ":")) == expected
    assert DepositInfo.from_json(json.loads(expected)) == d


def test_default_block_header_digests():
    """The three default-tree digests of ``BlockHeader::new(4)`` from the
    golden BlockDetail literal (src/rollup/circuits/mod.rs:104) — each a
    Rust-computed Poseidon digest chain."""
    h = BlockHeader.new(4)
    assert h.block_headers_digest.to_hex() == DEFAULT_BLOCK_HEADERS_DIGEST
    assert h.transactions_digest.to_hex() == DEFAULT_TRANSACTIONS_DIGEST_D4
    assert h.deposit_digest.to_hex() == DEFAULT_DEPOSIT_DIGEST_D4


def test_golden_block_detail_json_string():
    """src/rollup/circuits/mod.rs:93-109: byte-exact serialization parity
    of the default BlockDetail (empty proof lists hide the only
    engine-specific payload, so full string equality is well-defined).

    The expected string is the JAX package's serialization of the same
    default object; ``tests/test_reference_literals.py`` holds that against
    the literal in the reference source.  Its header's digests are the
    literals cited above."""
    expected = json.dumps(JBlockDetail.new(4).to_json(), separators=(",", ":"))
    got = json.dumps(BlockDetail.new(4).to_json(), separators=(",", ":"))
    assert got == expected
    header = json.loads(got)["prev_block_header"]
    assert header["block_headers_digest"] == DEFAULT_BLOCK_HEADERS_DIGEST
    assert header["transactions_digest"] == DEFAULT_TRANSACTIONS_DIGEST_D4
    assert header["deposit_digest"] == DEFAULT_DEPOSIT_DIGEST_D4
    # and the decode side round-trips
    assert BlockDetail.from_json(json.loads(expected)) == BlockDetail.new(4)
