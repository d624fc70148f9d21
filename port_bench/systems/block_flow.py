"""The flagship block flow (the reference's ``src/bin/block_circuit.rs``), one
block a request, through the port's rollup API as
``models/rollup/block_flow.py::prove_user_txs_and_signatures`` and
``run_block_flow`` call it, with every private key, asset key, amount and
nonce drawn from the seed (``harness/traffic.py::block``): the user-tx
circuit proves sender 1, sender 2 and a default transaction as one
``prove_batch`` (K = 3); the zkDSA circuit proves sender 2's signature of the
proposal and a default one (K = 2); the recursive block circuit verifies the
eight inner proofs and proves the block (K = 1).  The three circuits come
from the set-up, not from the window."""

from __future__ import annotations

import random

import torch

from port_bench.harness import proofs as hp
from port_bench.reference import rollup as ref_rollup
from port_bench.reference import verifier as ref_verifier
from port_bench.systems.smt_process import circuit_config

KINDS = ("user_tx", "signatures", "block")


def constants():
    from intmax_zkp_core_tpu_torch.config import RollupConstants

    return RollupConstants.test_constants()


class System:
    def __init__(self, cfg: dict, devices: list, cache_dir: str | None, rec, trace: bool,
                 overrides: dict | None = None):
        self.cfg, self.devices, self.rec, self.trace = cfg, devices, rec, trace
        self.cache_dir = cache_dir
        self.config = circuit_config(cfg, overrides)
        self.constants = constants()
        self.recursive = cfg.get("recursive", True)

    def setup(self, warm_requests) -> None:
        from intmax_zkp_core_tpu_torch import runtime
        from intmax_zkp_core_tpu_torch.engine.circuit_cache import load_or_build
        from intmax_zkp_core_tpu_torch.models.rollup import block_flow as bf
        from intmax_zkp_core_tpu_torch.models.rollup.circuits import make_block_proof_circuit
        from intmax_zkp_core_tpu_torch.models.transaction.circuits import make_user_proof_circuit
        from intmax_zkp_core_tpu_torch.models.zkdsa.circuits import make_simple_signature_circuit

        for device in self.devices:
            runtime.warmup(device)
        c, cfg, dev = self.constants, self.config, self.devices[0]
        with self.rec.span("circuit_load"):
            self.user_tx = load_or_build(bf.user_tx_circuit_name(c), cfg,
                                         lambda d: make_user_proof_circuit(c, cfg, d),
                                         self.cache_dir, dev)
            self.zkdsa = load_or_build("zkdsa", cfg, lambda d: make_simple_signature_circuit(cfg, d),
                                       self.cache_dir, dev)
            self.block = load_or_build(
                bf.block_circuit_name(c, self.recursive, self.user_tx, self.zkdsa), cfg,
                lambda d: make_block_proof_circuit(c, self.user_tx, self.zkdsa, cfg,
                                                   recursive=self.recursive, device=d),
                self.cache_dir, dev)
        with self.rec.span("warm"):
            self.serve(next(warm_requests))

    def _prove(self, data, pws) -> list:
        from intmax_zkp_core_tpu_torch.engine import prover

        timings = {} if self.trace else None
        with self.rec.span("prove"):
            out = prover.prove_batch(data, pws, timings=timings)
            for device in self.devices:
                if device.type == "cuda":
                    torch.cuda.synchronize(device)
        self.rec.add_phases(timings)
        return out

    def serve(self, scn: dict) -> dict:
        """One block of the scenario ``scn``: the proofs by kind."""
        from intmax_zkp_core_tpu_torch.config import LOG_MAX_N_BLOCKS
        from intmax_zkp_core_tpu_torch.engine.witness import PartialWitness
        from intmax_zkp_core_tpu_torch.models.merkle_tree.tree import get_merkle_proof
        from intmax_zkp_core_tpu_torch.models.rollup.block_flow import (
            SimpleSignaturePublicInputsFromProof,
        )
        from intmax_zkp_core_tpu_torch.models.rollup.circuits import BlockDetail
        from intmax_zkp_core_tpu_torch.models.rollup.gadgets.deposit_block import (
            DepositInfo,
            VariableIndex,
        )
        from intmax_zkp_core_tpu_torch.models.sparse_merkle_tree import (
            LayeredLayeredSparseMerkleTree,
            SparseMerkleInclusionProof,
            SparseMerkleTree,
        )
        from intmax_zkp_core_tpu_torch.models.sparse_merkle_tree.node_data import (
            NodeDataMemory,
            RootDataTmp,
        )
        from intmax_zkp_core_tpu_torch.models.sparse_merkle_tree.tree import calc_inclusion_proof
        from intmax_zkp_core_tpu_torch.models.transaction.block_header import (
            BlockHeader,
            get_block_hash,
        )
        from intmax_zkp_core_tpu_torch.models.transaction.circuits import (
            MergeAndPurgeTransitionPublicInputs,
        )
        from intmax_zkp_core_tpu_torch.models.transaction.gadgets.merge import MergeProof
        from intmax_zkp_core_tpu_torch.models.transaction.user_asset_tree import UserAssetTree
        from intmax_zkp_core_tpu_torch.models.zkdsa.account import Address, private_key_to_account
        from intmax_zkp_core_tpu_torch.utils.hash_out import HashOut
        from intmax_zkp_core_tpu_torch.utils.poseidon_host import two_to_one

        c = self.constants
        u = HashOut.from_u128
        m = u(scn["merge_key"])
        c1, c2 = (u(x) for x in scn["contracts"])
        v = u(scn["variable"])
        r1, r2 = (u(x) for x in scn["recipients"])
        value1, value2 = (u(x) for x in scn["amounts"])
        key1, key2, key3, key4 = (m, c1, v), (m, c2, v), (r1, c1, v), (r2, c2, v)
        value3, value4 = value1, value2

        with self.rec.span("app"):
            aggregator_nodes = NodeDataMemory()
            world_state_tree = SparseMerkleTree(aggregator_nodes, RootDataTmp())

            # sender 1: transfers two assets it holds
            sender1 = private_key_to_account(HashOut(tuple(scn["sender_keys"][0])))
            s1_nodes = NodeDataMemory()
            s1_assets = UserAssetTree(s1_nodes, RootDataTmp())
            s1_diff = LayeredLayeredSparseMerkleTree(s1_nodes, RootDataTmp())
            s1_assets.set(*key1, value1)
            s1_assets.set(*key2, value2)
            world_state_tree.set(sender1.address.to_hash_out(), s1_assets.get_root())
            p1 = s1_assets.set(*key2, HashOut.ZERO)
            p2 = s1_assets.set(*key1, HashOut.ZERO)
            p3 = s1_diff.set(*key3, value3)
            p4 = s1_diff.set(*key4, value4)
            s1_inputs, s1_outputs = [p1, p2], [p3, p4]

            # sender 2: merges a deposit made in the previous block
            sender2 = private_key_to_account(HashOut(tuple(scn["sender_keys"][1])))
            s2_nodes = NodeDataMemory()
            s2_assets = UserAssetTree(s2_nodes, RootDataTmp())
            s2_diff = LayeredLayeredSparseMerkleTree(s2_nodes, RootDataTmp())
            block1_deposits = LayeredLayeredSparseMerkleTree(aggregator_nodes, RootDataTmp())
            s2_h = sender2.address.to_hash_out()
            block1_deposits.set(s2_h, key1[1], key1[2], value1)
            block1_deposits.set(s2_h, key2[1], key2[2], value2)
            inclusion2 = calc_inclusion_proof(aggregator_nodes, block1_deposits.get_root(), s2_h)
            deposit_nonce = HashOut.ZERO
            deposit_tx_hash = two_to_one(inclusion2.root, deposit_nonce)
            inclusion1 = get_merkle_proof([deposit_tx_hash], 0, c.log_n_txs)
            default_inclusion = SparseMerkleInclusionProof.with_root(HashOut.ZERO)
            default_merkle_root = get_merkle_proof([], 0, c.log_n_txs).root
            prev_block_number = 1
            block_headers = [HashOut.ZERO] * prev_block_number
            prev_headers_digest = get_merkle_proof(block_headers, prev_block_number - 1,
                                                   LOG_MAX_N_BLOCKS).root
            prev_world_state = world_state_tree.get_root()
            prev_header = BlockHeader(
                block_number=prev_block_number, prev_block_hash=HashOut.ZERO,
                block_headers_digest=prev_headers_digest, transactions_digest=default_merkle_root,
                deposit_digest=inclusion1.root, proposed_world_state_digest=prev_world_state,
                approved_world_state_digest=prev_world_state, latest_account_digest=HashOut.ZERO)
            prev_hash = get_block_hash(prev_header)
            block_headers.append(prev_hash)
            merge_key = two_to_one(deposit_tx_hash, prev_hash)
            s2_assets.set(merge_key, key1[1], key1[2], value1)
            s2_assets.set(merge_key, key2[1], key2[2], value2)
            s2_as_smt = SparseMerkleTree(s2_nodes, s2_assets.roots_db)
            asset_root = s2_as_smt.get(merge_key)
            s2_as_smt.set(merge_key, HashOut.ZERO)
            merge_process_proof = s2_as_smt.set(merge_key, asset_root)
            merge_proof = MergeProof(
                is_deposit=True, diff_tree_inclusion_proof=(prev_header, inclusion1, inclusion2),
                merge_process_proof=merge_process_proof,
                latest_account_tree_inclusion_proof=default_inclusion, nonce=deposit_nonce)
            p1 = s2_assets.set(merge_key, key2[1], key2[2], HashOut.ZERO)
            p2 = s2_assets.set(merge_key, key1[1], key1[2], HashOut.ZERO)
            p3 = s2_diff.set(*key3, value3)
            p4 = s2_diff.set(*key4, value4)
            s2_inputs, s2_outputs = [p1, p2], [p3, p4]

            targets = self.user_tx.targets
            pw1, pw2, pw3 = PartialWitness(), PartialWitness(), PartialWitness()
            targets.set_witness(pw1, sender1.address, [], s1_inputs[: c.n_diffs],
                                s1_outputs[: c.n_diffs], HashOut(tuple(scn["nonces"][0])),
                                s1_inputs[0][0].old_root)
            targets.set_witness(pw2, sender2.address, [merge_proof], s2_inputs[: c.n_diffs],
                                s2_outputs[: c.n_diffs], HashOut(tuple(scn["nonces"][1])),
                                HashOut.ZERO)
            targets.set_witness(pw3, Address(0), [], [], [], HashOut.ZERO, HashOut.ZERO)
        user_tx_proofs = self._prove(self.user_tx.data, [pw1, pw2, pw3])

        with self.rec.span("app"):
            ws1 = world_state_tree.set(sender1.address.to_hash_out(), s1_assets.get_root())
            ws2 = world_state_tree.set(sender2.address.to_hash_out(), s2_assets.get_root())
            proposal_root = world_state_tree.get_root()
            sig1, sig2 = PartialWitness(), PartialWitness()
            self.zkdsa.targets.set_witness(sig1, sender2.private_key, proposal_root)
            self.zkdsa.targets.set_witness(sig2, HashOut.ZERO, HashOut.ZERO)
        signature_proofs = self._prove(self.zkdsa.data, [sig1, sig2])

        with self.rec.span("app"):
            block_number = prev_header.block_number + 1
            received = [None, signature_proofs[0]]
            signatures = [None if p is None else SimpleSignaturePublicInputsFromProof(p)
                          for p in received]
            latest_account_tree = SparseMerkleTree(NodeDataMemory(), RootDataTmp(HashOut.ZERO))
            reverts, latest = [], []
            transactions = [MergeAndPurgeTransitionPublicInputs.decode(p.public_inputs)
                            for p in user_tx_proofs[:2]]
            for sig, tx in zip(signatures, transactions):
                address = tx.sender_address.to_hash_out()
                if sig is None:
                    last = latest_account_tree.get(address).to_u32()
                    confirmed = tx.middle_user_asset_root
                else:
                    last, confirmed = block_number, tx.new_user_asset_root
                latest.append(latest_account_tree.set(address, HashOut.from_u32(last)))
                reverts.append(world_state_tree.set(address, confirmed))
            bh_proof = get_merkle_proof(block_headers, prev_block_number, LOG_MAX_N_BLOCKS)
            deposits = [DepositInfo(receiver_address=sender2.address, contract_address=Address(1),
                                    variable_index=VariableIndex(0),
                                    amount=scn["deposit_amount"])]
            block2_deposits = LayeredLayeredSparseMerkleTree(aggregator_nodes, RootDataTmp())
            deposit_proofs = [
                block2_deposits.set(d.receiver_address.to_hash_out(),
                                    d.contract_address.to_hash_out(),
                                    d.variable_index.to_hash_out(), HashOut((d.amount, 0, 0, 0)))
                for d in deposits][: c.n_deposits]
            detail = BlockDetail(
                block_number=block_number, user_tx_proofs=list(user_tx_proofs[:2]),
                deposit_process_proofs=deposit_proofs, scroll_process_proofs=[],
                polygon_process_proofs=[], world_state_process_proofs=[ws1, ws2],
                world_state_revert_proofs=reverts, received_signature_proofs=received,
                latest_account_process_proofs=latest,
                block_headers_proof_siblings=bh_proof.siblings, prev_block_header=prev_header)
            pw, _ = self.block.witness(detail, user_tx_proofs[2], signature_proofs[1])
        block_proofs = self._prove(self.block.data, [pw])
        self.rec.count("blocks")
        self.rec.count("proofs", len(user_tx_proofs) + len(signature_proofs) + len(block_proofs))
        return {"user_tx": user_tx_proofs, "signatures": signature_proofs, "block": block_proofs}

    def work(self, scn, out) -> list:
        from port_bench.harness.roofline import batch_work

        work = []
        for kind, circuit in zip(KINDS, (self.user_tx, self.zkdsa, self.block)):
            work += batch_work(hp.shape(circuit.data.common, self.config), len(out[kind]),
                               [int(p.fri.pow_witness) for p in out[kind]])
        return work

    def plain_outputs(self, outputs) -> list:
        return [(scn, {k: [hp.plain(p) for p in out[k]] for k in KINDS}) for scn, out in outputs]

    def verifier_key(self) -> dict:
        fri, cc = self.cfg["circuit_config"]["fri"], self.cfg["circuit_config"]
        return {kind: hp.verifier_key(self.cfg["verifier_keys"][kind], fri, cc, circuit.data.common)
                for kind, circuit in zip(KINDS, (self.user_tx, self.zkdsa, self.block))}

    def release(self) -> None:
        self.user_tx = self.zkdsa = self.block = None


def judge(keys: dict, outputs: list, seed, rounds: int) -> dict:
    """Hold each block's proofs to the plain reference: ``missing``, proofs
    that never came (3 user-tx, 2 signature and 1 block proof a block);
    ``statement``, proofs whose public inputs differ from what the reference
    works out from the scenario (``reference/rollup.py``); ``rejected``, the
    proofs the plain verifier rejects of those it verifies: in each of
    ``rounds`` rounds, every proof of a block drawn from the seed, each lane
    of the user-tx and signature batches with them.  Each an exact count,
    its limit 0."""
    c = constants()
    want = {"user_tx": 3, "signatures": 2, "block": 1}
    missing = statement = 0
    for scn, proofs in outputs:
        expect = ref_rollup.statement(scn, c.log_n_txs, 1 << c.log_n_txs, c.n_deposits,
                                      c.n_scroll_flags)
        for kind in KINDS:
            got = proofs[kind]
            missing += max(0, want[kind] - len(got))
            statement += max(0, len(got) - want[kind])
            for proof, pis in zip(got, expect[kind]):
                if proof["public_inputs"] != [int(x) for x in pis]:
                    statement += 1
    rng = random.Random(f"{seed}:judge")
    jobs = []
    for _ in range(rounds if outputs else 0):
        _, proofs = rng.choice(outputs)
        # the block proof first: it takes longest to verify
        jobs += [(keys[kind], proof) for kind in reversed(KINDS) for proof in proofs[kind]]
    rejected = ref_verifier.count_rejected(jobs)
    attempted = sum(want.values()) * len(outputs)
    return {"attempted": attempted, "failed": min(attempted, missing + statement + rejected),
            "checks": {"missing": (missing, 0), "statement": (statement, 0),
                       "rejected": (rejected, 0)}}
