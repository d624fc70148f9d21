"""What each proof of one block of the flagship flow states (the reference's
``src/bin/block_circuit.rs`` scenario: sender 1 transfers two assets it
holds, sender 2 merges a deposit of the previous block and transfers it,
sender 2 signs the proposal, the block approves both), worked out from the
scenario's drawn values with the plain sparse Merkle tree.

Trees are held as their contents: a key with a zero value is absent, and an
empty tree's root is zero.  Digests are 4-tuples of ints."""

from __future__ import annotations

from .poseidon import hash_no_pad, two_to_one
from .smt import ZERO, SparseMerkleTree

LOG_MAX_N_BLOCKS = 32  # the block-headers tree (block_header.rs:20)


def u128(x: int) -> tuple:
    return tuple((x >> (32 * i)) & 0xFFFFFFFF for i in range(4))


def smt_root(entries: dict) -> tuple:
    tree = SparseMerkleTree()
    root = ZERO
    for key, value in entries.items():
        root = tree.set(key, value)
    return root


def layered_root(nested) -> tuple:
    """A tree of trees: a dict's values are the roots of the trees below
    (a leaf value is a digest); empty subtrees drop out."""
    if isinstance(nested, dict):
        return smt_root({k: r for k, r in ((k, layered_root(v)) for k, v in nested.items())
                         if r != ZERO})
    return tuple(nested)


def user_asset_root(merges: dict) -> tuple:
    """merge key -> {contract: {variable: amount}}: each merge key holds
    two_to_one(asset root, merge key), which stays when its assets are
    gone."""
    return smt_root({m: two_to_one(layered_root(assets), m) for m, assets in merges.items()})


def merkle_root(leaves: list, depth: int, zero: tuple = ZERO) -> tuple:
    """The dense Merkle tree of depth ``depth`` over ``leaves`` padded with
    ``zero`` (merkle_tree/tree.rs)."""
    nodes = list(leaves) or [zero]
    width = 1
    while width < len(nodes):
        width *= 2
    nodes += [zero] * (width - len(nodes))
    chain = [zero]
    for _ in range(1, depth):
        chain.append(two_to_one(chain[-1], chain[-1]))
    level = 0
    while len(nodes) > 1:
        nodes = [two_to_one(nodes[2 * j], nodes[2 * j + 1]) for j in range(len(nodes) // 2)]
        level += 1
    root = nodes[0]
    for sibling in chain[level:]:
        root = two_to_one(root, sibling)
    return root


def block_hash(h: dict) -> tuple:
    a = two_to_one((h["block_number"], 0, 0, 0), h["latest_account_digest"])
    b = two_to_one(h["deposit_digest"], h["transactions_digest"])
    d = two_to_one(h["proposed_world_state_digest"], h["approved_world_state_digest"])
    return two_to_one(h["block_headers_digest"], two_to_one(two_to_one(a, b), d))


def statement(scn: dict, log_n_txs: int, n_txs: int, n_deposits: int, n_flags: int) -> dict:
    """The public inputs of the block's three user-tx proofs, two signature
    proofs and the block proof, as the plain reference works them out."""
    sk1, sk2 = (tuple(k) for k in scn["sender_keys"])
    pk1, pk2 = two_to_one(sk1, sk1), two_to_one(sk2, sk2)
    addr1, addr2 = pk1[0], pk2[0]
    a1h, a2h = (addr1, 0, 0, 0), (addr2, 0, 0, 0)
    m = u128(scn["merge_key"])
    c1, c2 = (u128(c) for c in scn["contracts"])
    v = u128(scn["variable"])
    r1, r2 = (u128(r) for r in scn["recipients"])
    amt1, amt2 = (u128(a) for a in scn["amounts"])
    n1, n2 = (tuple(n) for n in scn["nonces"])
    held = {c1: {v: amt1}, c2: {v: amt2}}

    # sender 1: holds both assets, sends them to r1 and r2
    s1_full = user_asset_root({m: held})
    s1_new = user_asset_root({m: {}})
    diff = layered_root({r1: {c1: {v: amt1}}, r2: {c2: {v: amt2}}})
    tx1 = two_to_one(diff, n1)
    ws_prev = smt_root({a1h: s1_full})

    # the previous block: its deposit to sender 2, its header and hash
    deposit_root = layered_root({a2h: held})
    deposit_tx_hash = two_to_one(deposit_root, ZERO)
    prev_header = {
        "block_number": 1,
        "latest_account_digest": ZERO,
        "deposit_digest": merkle_root([deposit_tx_hash], log_n_txs),
        "transactions_digest": merkle_root([], log_n_txs),
        "proposed_world_state_digest": ws_prev,
        "approved_world_state_digest": ws_prev,
        "block_headers_digest": merkle_root([ZERO], LOG_MAX_N_BLOCKS),
    }
    prev_hash = block_hash(prev_header)
    dmk = two_to_one(deposit_tx_hash, prev_hash)

    # sender 2: merges the deposit, then sends the same two transfers
    s2_middle = user_asset_root({dmk: held})
    s2_new = user_asset_root({dmk: {}})
    tx2 = two_to_one(diff, n2)
    default_tx = two_to_one(ZERO, ZERO)

    def user_tx(old, middle, new, d, addr, tx):
        return [*old, *middle, *new, *d, addr, 0, 0, 0, *tx]

    user_txs = [user_tx(s1_full, s1_full, s1_new, diff, addr1, tx1),
                user_tx(ZERO, s2_middle, s2_new, diff, addr2, tx2),
                user_tx(ZERO, ZERO, ZERO, ZERO, 0, default_tx)]

    # the proposal, signed by sender 2; the default signature
    proposed = smt_root({a1h: s1_new, a2h: s2_new})
    signatures = [[*proposed, *pk2, *two_to_one(sk2, proposed)],
                  [*ZERO, *two_to_one(ZERO, ZERO), *two_to_one(ZERO, ZERO)]]

    # the block: sender 1 did not sign (its assets stay), sender 2 did
    approved = smt_root({a1h: s1_full, a2h: s2_new})
    latest_account = smt_root({a2h: (2, 0, 0, 0)})
    receiver, contract, variable = addr2, 1, 0
    interior = layered_root({a2h: {(contract, 0, 0, 0): {(variable, 0, 0, 0):
                                                          (scn["deposit_amount"], 0, 0, 0)}}})
    header = {
        "block_number": 2,
        "latest_account_digest": latest_account,
        "deposit_digest": merkle_root([interior, ZERO, ZERO], log_n_txs),
        "transactions_digest": merkle_root([tx1, tx2], log_n_txs, default_tx),
        "proposed_world_state_digest": proposed,
        "approved_world_state_digest": approved,
        "block_headers_digest": merkle_root([ZERO, prev_hash], LOG_MAX_N_BLOCKS),
    }
    encoded = []
    for addr, valid in [(addr1, 0), (addr2, 1)] + [(0, 0)] * (n_txs - 2):
        encoded += [addr, 0, 0, 0, valid]
    deposits = [(receiver, contract, variable, scn["deposit_amount"])]
    deposits += [(0, 0, 0, 0)] * (n_deposits - 1) + [(0, 0, 0, 0)] * (2 * n_flags)
    for rcv, con, var, amount in deposits:
        encoded += [rcv, 0, 0, 0, con, 0, 0, 0, var, 0, 0, 0, amount]
    for h in (ZERO, latest_account, ws_prev, approved, prev_header["block_headers_digest"],
              header["block_headers_digest"], block_hash(header)):
        encoded += list(h)
    return {"user_tx": user_txs, "signatures": signatures, "block": [list(hash_no_pad(encoded))]}
