"""The block circuit's four rollup gadgets, each alone in a circuit at the
``MINI`` rollup constants and ``MINI_CFG``, with one seeded witness.

Written once for both packages (``prefix`` names the package), so that the
port's test (``tests/test_torch_rollup.py``) and the script that takes the
JAX package's digests (``experiments/make_block_goldens.py gadgets``) build
the same circuits and witnesses:

* ``deposit``: ``DepositBlockProductionTarget`` over one seeded deposit;
  public inputs the interior deposit digest;
* ``proposal``: ``ProposalBlockProductionTarget``, two of four slots
  enabled; the old root, the transactions digest, the new root;
* ``approval``: ``ApprovalBlockProductionTarget``, one signed and one
  unsigned user; the old and new world-state and latest-account roots;
* ``block_headers``: ``calc_block_headers_proof`` appending a seeded
  previous header at block number 3; the new block-headers root.

``make(prefix, name, **builder_kwargs)`` returns ``(data, witness)``:
``data`` is what the builder's ``build()`` gives, ``witness(pw)`` sets a
partial witness and returns the public inputs it must give.

``records_sha256(builder)`` hashes a builder's records before ``build()``
(rows, generator records, copy classes, places, presets, public inputs) in
one form for both packages: the recursive block circuit's records are held
against the JAX builder's through it
(``golden/block_records_standard.sha256``).
"""

from __future__ import annotations

import hashlib
import importlib
import random
from types import SimpleNamespace

P = 0xFFFFFFFF00000001
GADGETS = ("deposit", "proposal", "approval", "block_headers")


def package(prefix: str) -> SimpleNamespace:
    def m(name):
        return importlib.import_module(f"{prefix}.{name}")

    circuit, hash_out, smt = m("engine.circuit"), m("utils.hash_out"), m("models.sparse_merkle_tree")
    deposit, proposal = m("models.rollup.gadgets.deposit_block"), m("models.rollup.gadgets.proposal_block")
    approval, tree = m("models.rollup.gadgets.approval_block"), m("models.merkle_tree.tree")
    header, header_gadget = m("models.transaction.block_header"), m("models.transaction.gadgets.block_header")
    mini = m("models.rollup.mini_block")
    return SimpleNamespace(
        CircuitBuilder=circuit.CircuitBuilder, HashOut=hash_out.HashOut,
        Address=m("models.zkdsa.account").Address,
        LayeredLayeredSparseMerkleTree=smt.LayeredLayeredSparseMerkleTree,
        SparseMerkleTree=smt.SparseMerkleTree,
        VariableIndex=deposit.VariableIndex,
        DepositBlockProductionTarget=deposit.DepositBlockProductionTarget,
        ProposalBlockProductionTarget=proposal.ProposalBlockProductionTarget,
        ApprovalBlockProductionTarget=approval.ApprovalBlockProductionTarget,
        MergeAndPurgeTransitionPublicInputs=m(
            "models.transaction.circuits").MergeAndPurgeTransitionPublicInputs,
        SimpleSignaturePublicInputs=m("models.zkdsa.circuits").SimpleSignaturePublicInputs,
        BlockHeader=header.BlockHeader, get_block_hash=header.get_block_hash,
        BlockHeaderTarget=header_gadget.BlockHeaderTarget,
        calc_block_headers_proof=m(
            "models.rollup.gadgets.block_headers_tree").calc_block_headers_proof,
        get_merkle_proof=tree.get_merkle_proof, get_merkle_root=tree.get_merkle_root,
        LOG_MAX_N_BLOCKS=m("config").LOG_MAX_N_BLOCKS, MINI=mini.MINI, MINI_CFG=mini.MINI_CFG,
    )


def _digests(ns, rng):
    return lambda: ns.HashOut(tuple(rng.randrange(P) for _ in range(4)))  # noqa: E731


def _deposit(ns, b):
    k = ns.MINI
    t = ns.DepositBlockProductionTarget.add_virtual_to(
        b, k.log_n_recipients, k.log_n_contracts, k.log_n_variables, k.n_deposits)
    b.register_public_inputs(list(t.interior_deposit_digest))

    def witness(pw):
        rng = random.Random(71)
        tree = ns.LayeredLayeredSparseMerkleTree()
        proofs = [tree.set(ns.Address(rng.randrange(1, 8)).to_hash_out(),
                           ns.Address(rng.randrange(1, 8)).to_hash_out(),
                           ns.VariableIndex(rng.randrange(8)).to_hash_out(),
                           ns.HashOut((rng.randrange(1, 1 << 32), 0, 0, 0)))
                  for _ in range(k.n_deposits)]
        return list(t.set_witness(pw, proofs).elements)
    return witness


def _user_tx(ns, digest, address, old, new):
    return ns.MergeAndPurgeTransitionPublicInputs(
        sender_address=ns.Address(address), old_user_asset_root=old,
        middle_user_asset_root=digest(), new_user_asset_root=new, diff_root=digest(),
        tx_hash=digest())


def _proposal(ns, b):
    t = ns.ProposalBlockProductionTarget.add_virtual_to(
        b, ns.MINI.log_max_n_users, 1 << ns.MINI.log_n_txs)
    b.register_public_inputs(
        list(t.old_world_state_root) + list(t.transactions_digest) + list(t.new_world_state_root))

    def witness(pw):
        digest = _digests(ns, random.Random(72))
        world_state = ns.SparseMerkleTree()
        users = [(address, digest(), digest()) for address in (1, 6)]
        for address, old, _ in users:
            world_state.set(ns.Address(address).to_hash_out(), old)
        old_root = world_state.get_root()
        proofs = [world_state.set(ns.Address(a).to_hash_out(), new) for a, _, new in users]
        txs = [_user_tx(ns, digest, a, old, new) for a, old, new in users]
        transactions_digest, new_root = t.set_witness(pw, proofs, txs, old_root)
        return [*old_root.elements, *transactions_digest.elements, *new_root.elements]
    return witness


def _approval(ns, b):
    t = ns.ApprovalBlockProductionTarget.add_virtual_to(
        b, ns.MINI.log_max_n_users, 1 << ns.MINI.log_n_txs)
    b.register_public_inputs(
        list(t.old_world_state_root) + list(t.new_world_state_root)
        + list(t.old_latest_account_root) + list(t.new_latest_account_root))

    def witness(pw):
        digest = _digests(ns, random.Random(73))
        block_number, signed, unsigned = 5, 2, 5
        txs = [_user_tx(ns, digest, a, digest(), digest()) for a in (signed, unsigned)]
        world_state = ns.SparseMerkleTree()
        for u in txs:
            world_state.set(u.sender_address.to_hash_out(), u.new_user_asset_root)
        proposed_root = world_state.get_root()
        reverts = [world_state.set(txs[0].sender_address.to_hash_out(), txs[0].new_user_asset_root),
                   world_state.set(txs[1].sender_address.to_hash_out(),
                                   txs[1].middle_user_asset_root)]
        latest = ns.SparseMerkleTree()
        latest.set(txs[1].sender_address.to_hash_out(), ns.HashOut.from_u32(3))
        old_latest_root = latest.get_root()
        latest_proofs = [
            latest.set(txs[0].sender_address.to_hash_out(), ns.HashOut.from_u32(block_number)),
            latest.set(txs[1].sender_address.to_hash_out(),
                       latest.get(txs[1].sender_address.to_hash_out())),
        ]
        signatures = [ns.SimpleSignaturePublicInputs(
            message=proposed_root, public_key=digest(), signature=digest()), None]
        new_root, new_latest_root = t.set_witness(
            pw, block_number, reverts, txs, signatures, latest_proofs, proposed_root,
            old_latest_root)
        return [*proposed_root.elements, *new_root.elements, *old_latest_root.elements,
                *new_latest_root.elements]
    return witness


def _block_headers(ns, b):
    prev = ns.BlockHeaderTarget.add_virtual_to(b)
    siblings = b.add_virtual_hashes(ns.LOG_MAX_N_BLOCKS)
    proof = ns.calc_block_headers_proof(b, siblings, prev)
    b.register_public_inputs(list(proof.root))

    def witness(pw):
        digest = _digests(ns, random.Random(74))
        number = 3
        earlier = [digest() for _ in range(number)]
        path = ns.get_merkle_proof(earlier + [ns.HashOut.ZERO], number,
                                   ns.LOG_MAX_N_BLOCKS).siblings
        header = ns.BlockHeader(
            block_number=number, prev_block_hash=digest(),
            block_headers_digest=ns.get_merkle_root(number, ns.HashOut.ZERO, path),
            transactions_digest=digest(), deposit_digest=digest(),
            proposed_world_state_digest=digest(), approved_world_state_digest=digest(),
            latest_account_digest=digest())
        prev.set_witness(pw, header)
        for t, s in zip(siblings, path):
            pw.set_hash_target(t, s)
        return list(ns.get_merkle_root(number, ns.get_block_hash(header), path).elements)
    return witness


def make(prefix: str, name: str, **builder_kwargs):
    ns = package(prefix)
    b = ns.CircuitBuilder(ns.MINI_CFG, **builder_kwargs)
    witness = {"deposit": _deposit, "proposal": _proposal, "approval": _approval,
               "block_headers": _block_headers}[name](ns, b)
    return b.build(), witness


def records_sha256(builder) -> str:
    """sha256 of the records' ``repr``, each in the order the builder made
    it (both packages' builders keep the same containers)."""
    records = (builder.rows, builder.generators, builder.parent, builder.targets_at_place,
               builder.preset_values, builder.public_input_targets)
    return hashlib.sha256(repr(records).encode()).hexdigest()
