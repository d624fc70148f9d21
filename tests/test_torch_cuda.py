"""The CUDA kernels of the port against their plain PyTorch versions, on the
card.  A CUDA kernel has no interpret mode, so these tests need an NVIDIA GPU
and nvcc; without a CUDA device they skip.  Run them on the GPU machine with

    python -m pytest tests/test_torch_cuda.py -q -m cuda

(``python3 chip_smoke.py`` makes the same comparisons at more shapes and
drives a whole proof)."""

import numpy as np
import pytest
import torch

from intmax_zkp_core_tpu_torch.ops import cuda_build as cb
from intmax_zkp_core_tpu_torch.ops import fri_init_cuda as fi
from intmax_zkp_core_tpu_torch.ops import gate_quotient_cuda as gqc
from intmax_zkp_core_tpu_torch.ops import goldilocks as gl
from intmax_zkp_core_tpu_torch.ops import ntt_cuda as nc
from intmax_zkp_core_tpu_torch.ops import perm_columns_cuda as pcol
from intmax_zkp_core_tpu_torch.ops import perm_quotient_cuda as pq
from intmax_zkp_core_tpu_torch.ops import poseidon_cuda as pc
from intmax_zkp_core_tpu_torch.ops import zinv_mul_cuda as zm

torch.set_num_threads(1)

P = 0xFFFFFFFF00000001


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: the kernels run only on the card")
    return torch.device("cuda")


def _rand(seed, shape, device, loose=False):
    """Canonical lanes with 0 and p - 1 mixed in; with ``loose``, every third
    lane in [p, 2^64), p and 2^64 - 1 among them."""
    rng = np.random.default_rng(seed)
    a = rng.integers(0, P, size=shape, dtype=np.uint64)
    a.reshape(-1)[::7] = 0
    a.reshape(-1)[3::11] = P - 1
    if loose:
        a.reshape(-1)[1::3] = rng.integers(P, 1 << 64, size=a.size, dtype=np.uint64)[1::3]
        a.reshape(-1)[1::13] = P
        a.reshape(-1)[2::17] = (1 << 64) - 1
    return gl.from_u64(a, device)


@pytest.mark.cuda
@pytest.mark.parametrize("loose", [False, True])
@pytest.mark.parametrize("rows", [1, 255, 4099])
def test_permute_cuda_equals_plain(card, rows, loose):
    x = _rand(rows, (rows, 12), card, loose)
    before = pc.launch_counts()["permute_cuda"]
    got = pc.permute_cuda(x)
    assert pc.launch_counts()["permute_cuda"] == before + 1
    assert torch.equal(got, pc.permute_plain(x))


@pytest.mark.cuda
@pytest.mark.parametrize("loose", [False, True])
@pytest.mark.parametrize("width", [1, 2, 8, 9, 15, 135])
def test_hash_no_pad_cuda_equals_plain(card, width, loose):
    x = _rand(width, (1030, width), card, loose)
    want = pc.hash_no_pad_plain(x)
    before = pc.launch_counts()["hash_no_pad_cuda"]
    assert torch.equal(pc.hash_no_pad_cuda(x), want)
    assert torch.equal(pc.hash_no_pad_cuda(x.t().contiguous().t()), want)
    assert pc.launch_counts()["hash_no_pad_cuda"] == before + 2


@pytest.mark.cuda
def test_cuda_tensor_never_takes_the_plain_path(card):
    with pytest.raises(ValueError):
        pc.permute_cuda(torch.zeros((12, 8), dtype=torch.int64, device=card).t())


@pytest.mark.cuda
@pytest.mark.parametrize("rows", [(), (4,)], ids=str)
def test_zinv_mul_cuda_equals_plain(card, rows):
    acc, z_h = _rand(1, rows + (4104,), card), _rand(2, (4104,), card)
    z_h[:3] = torch.tensor([0, 1, -(1 << 32)], device=card)  # 0, 1, p-1
    before = pc.launch_counts()["zinv_mul_cuda"]
    got = zm.zinv_mul_cuda(acc, z_h)
    assert pc.launch_counts()["zinv_mul_cuda"] == before + 1
    assert torch.equal(got, zm.zinv_mul_plain(acc, z_h))


@pytest.mark.cuda
@pytest.mark.parametrize("K", [1, 3])
def test_fri_initial_cuda_equals_plain(card, K):
    L = 4104
    args = [_rand(3, (K, L, 2), card), _rand(4, (K, L, 2), card), _rand(5, (L,), card)]
    args += [_rand(6 + i, (K, 2), card) for i in range(4)]
    before = pc.launch_counts()["fri_initial_cuda"]
    got = fi.fri_initial_cuda(*args)
    assert pc.launch_counts()["fri_initial_cuda"] == before + 1
    assert torch.equal(got, fi.fri_initial_plain(*args))


@pytest.mark.cuda
@pytest.mark.parametrize("C", [1, 2, 3, 5])  # 5: above the kernel's template, no limit
@pytest.mark.parametrize("R", [3, 8, 80])
def test_perm_quotient_cuda_equals_plain(card, R, C):
    K, L, nch = 2, 1032, pq.n_chunks(R)
    args = [_rand(10, (K, R + 5, L), card), _rand(11, (K, C, L), card),
            _rand(12, (K, C, nch - 1, L), card)]
    args += [_rand(13 + i, (K, C), card) for i in range(3)]
    args += [_rand(16, (R, L), card), _rand(17, (L,), card), _rand(18, (L,), card),
             _rand(19, (R,), card)]
    before = pc.launch_counts()["perm_quotient_cuda"]
    acc, apows = pq.perm_quotient_cuda(*args, 8)
    assert pc.launch_counts()["perm_quotient_cuda"] == before + 1
    want_acc, want_apows = pq.perm_quotient_plain(*args, 8)
    assert torch.equal(acc, want_acc) and torch.equal(apows, want_apows)


@pytest.mark.cuda
@pytest.mark.parametrize("R,n,C", [(3, 1032, 2), (8, 1032, 2), (80, 1032, 2), (80, 1032, 5),
                                   (80, 40000, 2)])  # 40000: more block totals than one scan step
def test_perm_columns_cuda_equals_plain(card, R, n, C):
    K = 2
    args = [_rand(20, (K, R + 5, n), card), _rand(21, (K, C), card), _rand(22, (K, C), card),
            _rand(23, (R, n), card), _rand(24, (R, n), card)]
    before = pc.launch_counts()["perm_columns_cuda"]
    got = pcol.perm_columns_cuda(*args)
    assert pc.launch_counts()["perm_columns_cuda"] == before + pcol.LAUNCHES_PER_CALL == before + 3
    for a, b in zip(got, pcol.perm_columns_plain(*args)):
        assert torch.equal(a, b) and _canonical(a)


@pytest.mark.cuda
def test_new_wrappers_never_take_the_plain_path_for_a_cuda_tensor(card):
    # an input the kernel cannot index raises; nothing falls back to the plain version
    acc, z_h = _rand(1, (2, 64), card), _rand(2, (64,), card)
    with pytest.raises(ValueError):
        zm.zinv_mul_cuda(acc.t().contiguous().t(), z_h)
    comb = _rand(3, (1, 64, 4), card)[:, :, :2]
    scal = _rand(4, (1, 2), card)
    with pytest.raises(ValueError):
        fi.fri_initial_cuda(comb, comb, z_h, scal, scal, scal, scal)
    wires = _rand(5, (1, 64, 7), card).transpose(1, 2)  # [1, 7, 64], last axis strided
    tbl = _rand(6, (7, 64), card)
    with pytest.raises(ValueError):
        pcol.perm_columns_cuda(wires, scal, scal, tbl, tbl)
    with pytest.raises(ValueError):
        pq.perm_quotient_cuda(wires, _rand(7, (1, 2, 64), card), _rand(8, (1, 2, 0, 64), card),
                              scal, scal, scal, tbl, z_h, z_h, _rand(9, (7,), card), 8)


@pytest.mark.cuda
@pytest.mark.parametrize("K,C,L", [(1, 2, 64), (3, 2, 1030), (2, 4, 200)])
def test_poseidon_gate_quotient_cuda_equals_plain(card, K, C, L):
    args = [_rand(30, (K, 137, L), card), _rand(31, (L,), card), _rand(32, (K, C), card),
            _rand(33, (K, C, L), card), _rand(34, (K, C), card)]
    before = pc.launch_counts()["poseidon_gate_quotient_cuda"]
    acc, apows = gqc.poseidon_gate_quotient_cuda(*args)
    assert pc.launch_counts()["poseidon_gate_quotient_cuda"] == before + 1
    want_acc, want_apows = gqc.poseidon_gate_quotient_plain(*args)
    assert torch.equal(acc, want_acc) and torch.equal(apows, want_apows)


@pytest.mark.cuda
@pytest.mark.parametrize("B,log_n", [(1, 0), (3, 1), (5, 6), (2, 11), (3, 12), (2, 15), (1, 17)])
@pytest.mark.parametrize("inverse", [False, True])
def test_ntt_cuda_equals_plain(card, B, log_n, inverse):
    x = _rand(40 + log_n, (B, 1 << log_n), card)
    before = pc.launch_counts()["ntt_cuda"]
    got = nc.ntt_cuda(x, inverse)
    assert pc.launch_counts()["ntt_cuda"] == before + nc.launches_for(1 << log_n)
    assert torch.equal(got, nc.ntt_plain(x, inverse))


EDGE_LANES = [0, 1, (1 << 32) - 1, 1 << 32, 1 << 63, P - 1]


def _edge(seed, shape, device):
    """Canonical lanes, the first ones and every 97th holding 0, 1,
    2^32 - 1, 2^32, 2^63 and p - 1 in turn."""
    rng = np.random.default_rng(seed)
    a = rng.integers(0, P, size=shape, dtype=np.uint64)
    flat = a.reshape(-1)
    for i, v in enumerate(EDGE_LANES):
        flat[i::97 * len(EDGE_LANES)] = v
        flat[i * 97 + 1::97 * len(EDGE_LANES)] = v
    return gl.from_u64(a, device)


def _canonical(x):
    return bool((gl.to_u64(x.cpu()) < P).all())


@pytest.mark.cuda
@pytest.mark.parametrize("log_n", [0, 2, 3, 5, 9, 11, 15, 18],
                         ids=lambda m: f"2^{m}")  # R < 8, one pass, 2 / 3 / 4 passes, four-step
@pytest.mark.parametrize("B", [1, 24, 135])
def test_ntt_cuda_launch_plan_regimes_on_edge_lanes(card, B, log_n):
    x = _edge(60 + log_n + B, (B, 1 << log_n), card)
    for inverse in (False, True):
        before = pc.launch_counts()["ntt_cuda"]
        got = nc.ntt_cuda(x, inverse)
        assert pc.launch_counts()["ntt_cuda"] == before + nc.launches_for(1 << log_n)
        assert torch.equal(got, nc.ntt_plain(x, inverse)) and _canonical(got)


@pytest.mark.cuda
@pytest.mark.parametrize("C", [1, 3, 4, 5, 9])  # above 4: one launch per group of four
def test_poseidon_gate_quotient_cuda_every_challenge_count(card, C):
    K, L = 2, 1000  # L not a multiple of the kernel's block of points
    args = [_edge(70, (K, 135, L), card), _edge(71, (L,), card), _edge(72, (K, C), card),
            _edge(73, (K, C, L), card), _edge(74, (K, C), card)]
    before = pc.launch_counts()["poseidon_gate_quotient_cuda"]
    acc, apows = gqc.poseidon_gate_quotient_cuda(*args)
    assert pc.launch_counts()["poseidon_gate_quotient_cuda"] == before + -(-C // gqc.MAX_C)
    want_acc, want_apows = gqc.poseidon_gate_quotient_plain(*args)
    assert torch.equal(acc, want_acc) and torch.equal(apows, want_apows)
    assert _canonical(acc) and _canonical(apows)


@pytest.mark.cuda
def test_ntt_and_gate_wrappers_never_take_the_plain_path_for_a_cuda_tensor(card):
    x = _rand(50, (8, 64), card)
    with pytest.raises(ValueError):
        nc.ntt_cuda(x.t(), False)  # strided rows
    with pytest.raises(ValueError):
        nc.ntt_cuda(torch.empty((1, 1 << 33), dtype=torch.int64, device="meta"))  # no 2^33 roots
    x = _rand(51, (1, 1 << 23), card)  # the outer four-step: computed, as the JAX package does
    before = pc.launch_counts()["ntt_cuda"]
    assert torch.equal(nc.ntt_cuda(x, False), nc.ntt_plain(x, False))
    assert pc.launch_counts()["ntt_cuda"] == before + nc.launches_for(1 << 23)
    args = [_rand(52, (1, 135, 64), card), _rand(53, (64,), card), _rand(54, (1, 5), card),
            _rand(55, (1, 5, 64), card), _rand(56, (1, 5), card)]
    got = gqc.poseidon_gate_quotient_cuda(*args)  # C = 5: two launches
    assert all(torch.equal(g, w) for g, w in zip(got, gqc.poseidon_gate_quotient_plain(*args)))


@pytest.mark.cuda
@pytest.mark.parametrize("B,log_n", [(1, 23), (2, 24), (70_000, 12)], ids=str)
@pytest.mark.parametrize("inverse", [False, True])
def test_ntt_cuda_beyond_one_four_step_equals_plain(card, B, log_n, inverse):
    # n > 2^22: the outer four-step; more than 65,535 rows: several launches
    x = _rand(57 + log_n, (B, 1 << log_n), card)
    before = pc.launch_counts()["ntt_cuda"]
    got = nc.ntt_cuda(x, inverse)
    assert pc.launch_counts()["ntt_cuda"] == before + nc.launches_for(1 << log_n, B)
    assert torch.equal(got, nc.ntt_plain(x, inverse)) and _canonical(got)


PERIOD = 7  # distinct proofs tiled over K; 65,535 is no multiple of it


def _tiled(K, *distinct):
    """Each tensor's 7 distinct proofs repeated over K proofs."""
    idx = torch.arange(K, device=distinct[0].device) % PERIOD
    return [t[idx] for t in distinct]


@pytest.mark.cuda
def test_kernels_take_more_proofs_than_a_grid_axis(card):
    # K = 65,536 proofs, one more than the grid's second and third axes take;
    # the plain versions, one proof at a time, run on the 7 distinct ones
    K, L, R, C = cb.MAX_GRID_YZ + 1, 8, 9, 2
    idx = torch.arange(K, device=card) % PERIOD

    def check(cuda_fn, plain_fn, per_proof, shared):
        got = cuda_fn(*_tiled(K, *per_proof), *shared)
        want = plain_fn(*per_proof, *shared)
        got, want = (got, want) if isinstance(got, tuple) else ((got,), (want,))
        assert all(torch.equal(g, w[idx]) for g, w in zip(got, want))

    xs = _rand(82, (L,), card)
    check(lambda c1, c2, *r: fi.fri_initial_cuda(c1, c2, xs, *r),
          lambda c1, c2, *r: fi.fri_initial_plain(c1, c2, xs, *r),
          [_rand(80, (PERIOD, L, 2), card), _rand(81, (PERIOD, L, 2), card)] + [
              _rand(83 + i, (PERIOD, 2), card) for i in range(4)], [])
    sel = _rand(91, (L,), card)
    check(lambda w, *r: gqc.poseidon_gate_quotient_cuda(w, sel, *r),
          lambda w, *r: gqc.poseidon_gate_quotient_plain(w, sel, *r),
          [_rand(90, (PERIOD, 135, L), card), _rand(92, (PERIOD, C), card),
           _rand(93, (PERIOD, C, L), card), _rand(94, (PERIOD, C), card)], [])
    wires = _rand(95, (PERIOD, R, L), card)
    check(pcol.perm_columns_cuda, pcol.perm_columns_plain,
          [wires, _rand(96, (PERIOD, C), card), _rand(97, (PERIOD, C), card)],
          [_rand(98, (R, L), card), _rand(99, (R, L), card)])
    nch = pq.n_chunks(R)
    check(pq.perm_quotient_cuda, pq.perm_quotient_plain,
          [wires, _rand(100, (PERIOD, C, L), card), _rand(101, (PERIOD, C, nch - 1, L), card)]
          + [_rand(102 + i, (PERIOD, C), card) for i in range(3)],
          [_rand(105, (R, L), card), _rand(106, (L,), card), _rand(107, (L,), card),
           _rand(108, (R,), card), 8])


def _batch_points(layout, L):
    """The points of one thread in a kernel's layout (threads a block, points
    a thread, a block width apart): thread 1 of block 1."""
    threads, points = layout
    assert 3 * threads * points <= L
    return [threads * points + 1 + i * threads for i in range(points)]


@pytest.mark.cuda
@pytest.mark.parametrize("rows", [(), (1,), (4,)], ids=str)
def test_zinv_mul_cuda_zero_and_edge_lanes(card, rows):
    # zeros at the first, a middle and the last point of one thread, all the
    # points of another thread and of a whole block, and p (0 mod p, not
    # canonical); edge lanes
    L = 4104
    acc, z_h = _edge(75, rows + (L,), card), _edge(76, (L,), card)
    batch = _batch_points(zm.batch_layout(), L)
    span = zm.batch_layout()[0] * zm.batch_layout()[1]
    z_h[[batch[0], batch[len(batch) // 2], batch[-1]]] = 0
    z_h[[t + 2 for t in batch]] = 0
    z_h[2 * span : 3 * span] = 0
    z_h[-1] = -(1 << 32) + 1  # p
    before = pc.launch_counts()["zinv_mul_cuda"]
    got = zm.zinv_mul_cuda(acc, z_h)
    assert pc.launch_counts()["zinv_mul_cuda"] == before + 1
    assert torch.equal(got, zm.zinv_mul_plain(acc, z_h)) and _canonical(got)
    zeros = (z_h == 0) | (z_h == -(1 << 32) + 1)
    assert torch.equal(got != 0, (acc != 0) & ~zeros)


@pytest.mark.cuda
def test_fri_initial_cuda_zero_norms_and_edge_lanes(card):
    # K = 3 on edge lanes; proof k's zeta in the base field on the point at
    # the first, a middle or the last place of one thread's points, its
    # g*zeta likewise in another thread's: only that term of that point is
    # zero
    K, L = 3, 4104
    args = [_edge(77, (K, L, 2), card), _edge(78, (K, L, 2), card),
            gl.from_u64(np.random.default_rng(79).integers(0, P, size=L, dtype=np.uint64), card)]
    args += [_edge(80 + i, (K, 2), card) for i in range(4)]
    xs, zetas, gzetas = args[2], args[3], args[4]
    batch = _batch_points(fi.batch_layout(), L)
    for k, i in enumerate((0, len(batch) // 2, len(batch) - 1)):
        zetas[k] = torch.stack([xs[batch[i]], xs.new_zeros(())])
        gzetas[k] = torch.stack([xs[batch[i] + 1], xs.new_zeros(())])
    before = pc.launch_counts()["fri_initial_cuda"]
    got = fi.fri_initial_cuda(*args)
    assert pc.launch_counts()["fri_initial_cuda"] == before + 1
    assert torch.equal(got, fi.fri_initial_plain(*args)) and _canonical(got)


@pytest.mark.cuda
def test_smt_process_proof_at_depth_256_equals_golden(card):
    """The first proof of the SMT process loop at n_levels=256 and
    standard_recursion_config, made on the card, equals the JAX package's."""
    import hashlib
    import json
    import pathlib

    from intmax_zkp_core_tpu_torch.bin import verify_smt_process as vsp
    from intmax_zkp_core_tpu_torch.engine.serde import proof_to_json
    from intmax_zkp_core_tpu_torch.models.sparse_merkle_tree import SparseMerkleTree

    golden, digest = (pathlib.Path(__file__).resolve().parent.parent / "intmax_zkp_core_tpu_torch"
                      / "golden" / "smt_process_256_standard.sha256").read_text().splitlines()[:2]
    data, target = vsp.build_circuit(256, device=card)
    assert data.common.n == 4096
    assert tuple(data.common.circuit_digest) == tuple(int(x) for x in digest.split()[1:5])
    key, value = vsp.role_cycle(5, 256, seed=1)[0]
    _, pw = vsp.step(SparseMerkleTree(), target, key, value)
    proof = data.prove(pw)
    data.verify(proof)
    sha = hashlib.sha256(json.dumps(proof_to_json(proof), sort_keys=True).encode()).hexdigest()
    assert sha == golden.split()[0]


@pytest.mark.cuda
def test_chain_native_fill_equals_python_fill(card):
    """The native witness fill against the Python WitnessFill on a 2^11-row
    chain at standard_recursion_config."""
    from intmax_zkp_core_tpu_torch.engine.config import CircuitConfig
    from intmax_zkp_core_tpu_torch.engine.prover import compute_wire_matrix, compute_wire_matrix_plain
    from intmax_zkp_core_tpu_torch.models.hash_chain import links_for_rows, make_hash_chain_circuit
    from intmax_zkp_core_tpu_torch.utils.hash_out import HashOut

    chain = make_hash_chain_circuit(links_for_rows(11), CircuitConfig.standard_recursion_config(),
                                    device=card)
    pw = chain.witness(HashOut.from_u64(7), HashOut.from_u64(0xC0FFEE))
    wires, pi = compute_wire_matrix(chain.data.prover, pw)
    wires_py, pi_py = compute_wire_matrix_plain(chain.data.prover, pw)
    assert (wires == wires_py).all() and pi == pi_py


@pytest.fixture(scope="module")
def user_tx_flow():
    """The block flow's user-tx and signature batches on the card, at
    test_constants and standard_recursion_config (built once)."""
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: the kernels run only on the card")
    from intmax_zkp_core_tpu_torch.models.rollup.block_flow import prove_user_txs_and_signatures

    return prove_user_txs_and_signatures()


@pytest.mark.cuda
def test_prove_batch_equals_sequential_on_the_card(user_tx_flow):
    """The K = 3 user-tx batch: each proof equals a sequential prove of its
    witness on the card and the JAX package's (golden), and verifies; K3 - K7
    are launched as often per batch as per proof."""
    import hashlib
    import json
    import pathlib

    from intmax_zkp_core_tpu_torch.engine.batch_prover import prove_batch
    from intmax_zkp_core_tpu_torch.engine.serde import proof_to_json

    lines = [ln for ln in (pathlib.Path(__file__).resolve().parent.parent
                           / "intmax_zkp_core_tpu_torch" / "golden"
                           / "user_tx_flow_standard.sha256").read_text().splitlines()
             if not ln.startswith("#")]
    data, pws = user_tx_flow.user_tx_circuit.data, user_tx_flow.user_tx_witnesses
    assert data.common.n == 4096 and len(pws) == 3
    assert tuple(data.common.circuit_digest) == tuple(int(x) for x in lines[0].split()[1:5])
    before = pc.launch_counts()
    batch = prove_batch(data, pws)
    per_batch = {k: n - before[k] for k, n in pc.launch_counts().items()}
    before = pc.launch_counts()
    sequential = [data.prove(pw) for pw in pws]
    per_proof = {k: (n - before[k]) // 3 for k, n in pc.launch_counts().items()}
    for k, (bp, sp) in enumerate(zip(batch, sequential)):
        assert bp == sp == user_tx_flow.user_tx_proofs[k]
        sha = hashlib.sha256(json.dumps(proof_to_json(bp), sort_keys=True).encode()).hexdigest()
        assert sha == lines[1 + k].split()[0]
        data.verify(bp)
    for name in ("perm_columns_cuda", "perm_quotient_cuda", "zinv_mul_cuda", "fri_initial_cuda",
                 "poseidon_gate_quotient_cuda", "ntt_cuda"):
        assert per_batch[name] == per_proof[name], name


@pytest.mark.cuda
def test_small_user_tx_batch_equals_the_jax_proofs_on_the_card(card):
    """The purge-only transition of ``test_torch_transaction.py`` and the
    default transaction at its small constants, proved as one K = 2 batch on
    the card: equal to two ``prove`` calls and to the JAX package's proofs
    (``golden/user_tx_small_test.sha256``, first and third lines)."""
    import hashlib
    import json
    import pathlib

    from intmax_zkp_core_tpu_torch.config import RollupConstants
    from intmax_zkp_core_tpu_torch.engine.config import CircuitConfig, FriConfig
    from intmax_zkp_core_tpu_torch.engine.prover import prove_batch
    from intmax_zkp_core_tpu_torch.engine.serde import proof_to_json
    from intmax_zkp_core_tpu_torch.engine.witness import PartialWitness
    from intmax_zkp_core_tpu_torch.models.sparse_merkle_tree import (
        LayeredLayeredSparseMerkleTree,
    )
    from intmax_zkp_core_tpu_torch.models.transaction import circuits as tc
    from intmax_zkp_core_tpu_torch.models.transaction.user_asset_tree import UserAssetTree
    from intmax_zkp_core_tpu_torch.models.zkdsa.account import Address
    from intmax_zkp_core_tpu_torch.utils.hash_out import HashOut

    small = RollupConstants(  # tests/test_user_transaction.py::small_constants
        log_max_n_users=3, log_max_n_txs=3, log_max_n_contracts=3, log_max_n_variables=3,
        log_n_txs=2, log_n_recipients=3, log_n_contracts=3, log_n_variables=3,
        n_registrations=1, n_diffs=1, n_merges=1, n_deposits=1, n_scroll_flags=1,
        n_polygon_flags=1, n_blocks=2)
    c = tc.make_user_proof_circuit(
        small, CircuitConfig(fri=FriConfig(num_query_rounds=4, proof_of_work_bits=2)), card)
    merge_key, contract, variable = HashOut.from_u32(1), HashOut.from_u32(3), HashOut.from_u32(5)
    user_tree, diff_tree = UserAssetTree(), LayeredLayeredSparseMerkleTree()
    user_tree.set(merge_key, contract, variable, HashOut.from_u32(10))
    old_root = user_tree.get_root()
    purge_pw, _ = c.witness(tc.MergeAndPurgeTransition(
        sender_address=Address(777), merge_witnesses=[],
        purge_input_witnesses=[user_tree.set(merge_key, contract, variable, HashOut.ZERO)],
        purge_output_witnesses=[diff_tree.set(HashOut.from_u32(2), contract, variable,
                                              HashOut.from_u32(10))],
        nonce=HashOut.from_u32(99), old_user_asset_root=old_root))
    default_pw = PartialWitness()
    c.targets.set_witness(default_pw, Address(0), [], [], [], HashOut.ZERO, HashOut.ZERO)
    batch = prove_batch(c.data, [purge_pw, default_pw])
    assert batch == [c.data.prove(purge_pw), c.data.prove(default_pw)]
    lines = (pathlib.Path(__file__).resolve().parent.parent / "intmax_zkp_core_tpu_torch"
             / "golden" / "user_tx_small_test.sha256").read_text().splitlines()
    for proof, line in zip(batch, (lines[0], lines[2])):
        sha = hashlib.sha256(json.dumps(proof_to_json(proof), sort_keys=True).encode()).hexdigest()
        assert sha == line.split()[0]
        c.data.verify(proof)


@pytest.mark.cuda
def test_signature_batch_equals_sequential_in_both_wirings(user_tx_flow):
    from intmax_zkp_core_tpu_torch.engine.batch_prover import prove_batch

    data, pws = user_tx_flow.zkdsa_circuit.data, user_tx_flow.signature_witnesses
    sequential = [data.prove(pw) for pw in pws]
    assert user_tx_flow.signature_proofs == sequential
    assert prove_batch(data, pws, fused_sponge=True) == sequential


@pytest.mark.cuda
def test_kernels_at_user_tx_batch_shapes(card):
    """K3 - K7 at the K = 3 user-tx batch's shapes (n = 2^12, L = 2^15, the
    [3, 135, .] wire matrix and LDE), K2 at its batched rows and K1b on the
    copied leaves of three trees."""
    K, n, L, R, C, W = 3, 1 << 12, 1 << 15, 80, 2, 135
    wires = _rand(91, (K, W, n), card)
    args = [wires, _rand(92, (K, C), card), _rand(93, (K, C), card), _rand(94, (R, n), card),
            _rand(95, (R, n), card)]
    for got, want in zip(pcol.perm_columns_cuda(*args), pcol.perm_columns_plain(*args)):
        assert torch.equal(got, want)
    wires_lde = _rand(96, (K, W, L), card)
    args = [wires_lde, _rand(97, (K, C, L), card), _rand(98, (K, C, 11, L), card)]
    args += [_rand(99 + i, (K, C), card) for i in range(3)]
    args += [_rand(102, (R, L), card), _rand(103, (L,), card), _rand(104, (L,), card),
             _rand(105, (R,), card)]
    for got, want in zip(pq.perm_quotient_cuda(*args, 8), pq.perm_quotient_plain(*args, 8)):
        assert torch.equal(got, want)
    args = [wires_lde, _rand(106, (L,), card), _rand(107, (K, C), card),
            _rand(108, (K, C, L), card), _rand(109, (K, C), card)]
    for got, want in zip(gqc.poseidon_gate_quotient_cuda(*args),
                         gqc.poseidon_gate_quotient_plain(*args)):
        assert torch.equal(got, want)
    acc, z_h = _rand(110, (K * C, L), card), _rand(111, (L,), card)
    assert torch.equal(zm.zinv_mul_cuda(acc, z_h), zm.zinv_mul_plain(acc, z_h))
    args = [_rand(112, (K, L, 2), card), _rand(113, (K, L, 2), card), _rand(114, (L,), card)]
    args += [_rand(115 + i, (K, 2), card) for i in range(4)]
    assert torch.equal(fi.fri_initial_cuda(*args), fi.fri_initial_plain(*args))
    for B, length in ((K * W, n), (K * W, L), (K * 24, L), (K * 16, L), (2 * K, 256)):
        x = _rand(B + length, (B, length), card)
        for inverse in (False, True):
            assert torch.equal(nc.ntt_cuda(x, inverse), nc.ntt_plain(x, inverse))
    leaves = wires_lde.transpose(1, 2).reshape(K * L, W)
    assert torch.equal(pc.hash_no_pad_cuda(leaves), pc.hash_no_pad_plain(leaves))


def _golden_lines(name):
    import pathlib

    path = pathlib.Path(__file__).resolve().parent.parent / "intmax_zkp_core_tpu_torch" / "golden"
    return [ln for ln in (path / name).read_text().splitlines() if not ln.startswith("#")]


def _sha(proof):
    import hashlib
    import json

    from intmax_zkp_core_tpu_torch.engine.serde import proof_to_json

    return hashlib.sha256(json.dumps(proof_to_json(proof), sort_keys=True).encode()).hexdigest()


@pytest.mark.cuda
def test_mini_recursive_block_equals_the_jax_proofs(card):
    """``run_mini_recursive_block`` at MINI / MINI_CFG on the card: the block
    circuit's digest, the four inner proofs and the block proof equal the
    JAX package's (``golden/mini_block_test.sha256``), and every proof
    verifies."""
    from intmax_zkp_core_tpu_torch.models.rollup.mini_block import run_mini_recursive_block

    lines = _golden_lines("mini_block_test.sha256")
    r = run_mini_recursive_block()
    block = r["block_circuit"]
    assert tuple(block.data.common.circuit_digest) == tuple(int(x) for x in lines[0].split()[1:5])
    assert block.data.common.n == int(lines[0].split(";")[1].split()[0])
    inner = r["user_tx_proofs"] + r["signature_proofs"]
    assert [_sha(p) for p in inner + [r["block_proof"].proof]] == [ln.split()[0] for ln in lines[1:6]]
    block.verify(r["block_proof"])


@pytest.mark.cuda
def test_recursion_outer_proof_on_the_card(card):
    """The outer circuit of ``test_torch_recursion.py`` proved and verified on
    the card; a tampered inner proof makes the outer prove fail."""
    import copy

    from intmax_zkp_core_tpu_torch.engine.circuit import CircuitBuilder
    from intmax_zkp_core_tpu_torch.engine.config import CircuitConfig, FriConfig
    from intmax_zkp_core_tpu_torch.engine.witness import PartialWitness
    from intmax_zkp_core_tpu_torch.models.recursion.gadgets import RecursiveProofTarget
    from intmax_zkp_core_tpu_torch.models.zkdsa.circuits import make_simple_signature_circuit
    from intmax_zkp_core_tpu_torch.utils.hash_out import HashOut

    cfg = CircuitConfig(fri=FriConfig(num_query_rounds=3, proof_of_work_bits=2))
    inner = make_simple_signature_circuit(cfg)
    builder = CircuitBuilder(cfg)
    target = RecursiveProofTarget.add_virtual_to(builder, inner.data, in_circuit=True)
    builder.register_public_inputs(list(target.public_inputs))
    outer = builder.build()
    assert tuple(outer.common.circuit_digest) == tuple(
        int(x) for x in _golden_lines("recursion_zkdsa.sha256")[0].split()[1:5])
    proof = inner.prove(HashOut.from_u32(7), HashOut.from_u32(555))
    pw = PartialWitness()
    target.set_witness(pw, proof, True)
    outer_proof = outer.prove(pw)
    assert outer_proof.public_inputs == proof.public_inputs
    outer.verify(outer_proof)
    bad = copy.deepcopy(proof)
    bad.public_inputs[8] = (bad.public_inputs[8] + 1) % P
    pw = PartialWitness()
    target.set_witness(pw, bad, True)
    with pytest.raises(AssertionError):
        outer.prove(pw)


@pytest.mark.cuda
def test_recursive_block_circuit_at_test_constants_equals_jax(card):
    """The flagship's recursive block circuit (``test_constants``,
    ``standard_recursion_config``) built on the card: 65,536 rows and the
    JAX build's digest (``golden/block_flow_standard.sha256``)."""
    from intmax_zkp_core_tpu_torch.config import RollupConstants
    from intmax_zkp_core_tpu_torch.models.rollup.circuits import make_block_proof_circuit
    from intmax_zkp_core_tpu_torch.models.transaction.circuits import make_user_proof_circuit
    from intmax_zkp_core_tpu_torch.models.zkdsa.circuits import make_simple_signature_circuit

    constants = RollupConstants.test_constants()
    block = make_block_proof_circuit(
        constants, make_user_proof_circuit(constants), make_simple_signature_circuit())
    line = _golden_lines("block_flow_standard.sha256")[0]
    assert block.data.common.n == int(line.split(";")[1].split()[0]) == 1 << 16
    assert tuple(block.data.common.circuit_digest) == tuple(int(x) for x in line.split()[1:5])


@pytest.mark.cuda
def test_cached_circuit_proves_equal_to_its_fresh_build(card, tmp_path):
    """A zkDSA circuit through the circuit cache: written by a build on the
    CPU, read back for the card (``load_or_build``'s device is the
    caller's), and written by a build on the card and read back from disk;
    every proof equals the fresh build's."""
    from intmax_zkp_core_tpu_torch.engine import circuit_cache as cc
    from intmax_zkp_core_tpu_torch.engine.config import CircuitConfig, FriConfig
    from intmax_zkp_core_tpu_torch.models.zkdsa.circuits import make_simple_signature_circuit
    from intmax_zkp_core_tpu_torch.utils.hash_out import HashOut

    cfg = CircuitConfig(fri=FriConfig(num_query_rounds=3, proof_of_work_bits=2))
    sk, msg = HashOut.from_u64(42), HashOut.from_u64(0xABCDEF)
    fresh = make_simple_signature_circuit(cfg).prove(sk, msg)
    build = lambda device: make_simple_signature_circuit(cfg, device)  # noqa: E731
    cc._MEMO.clear()
    cpu_dir, card_dir = str(tmp_path / "cpu"), str(tmp_path / "card")
    written_on_cpu = cc.load_or_build("zkdsa", cfg, build, cpu_dir, device="cpu")
    assert _sha(written_on_cpu.prove(sk, msg)) == _sha(fresh)
    cc._MEMO.clear()
    loaded = cc.load_or_build("zkdsa", cfg, build, cpu_dir)
    assert loaded.data.device.type == "cuda"
    assert _sha(loaded.prove(sk, msg)) == _sha(fresh)
    cc.load_or_build("zkdsa", cfg, build, card_dir)
    cc._MEMO.clear()
    assert _sha(cc.load_or_build("zkdsa", cfg, build, card_dir).prove(sk, msg)) == _sha(fresh)
    cc._MEMO.clear()


@pytest.mark.cuda
def test_ecdsa_16_proof_equals_the_cpu_port(card):
    """The n_bits = 16 ECDSA verification circuit at the tiny config proved on
    the card: rows, digest and proof equal the JAX-made golden
    (``golden/ecdsa_16_test.sha256``), which the CPU port's proof equals
    (``test_torch_ecdsa.py``)."""
    from intmax_zkp_core_tpu_torch.bin.ecdsa_verification import demo_triple
    from intmax_zkp_core_tpu_torch.engine.config import CircuitConfig, FriConfig
    from intmax_zkp_core_tpu_torch.models.ecdsa.circuits import make_ecdsa_verification_circuit

    msg, sig, pk = demo_triple(16)
    cfg = CircuitConfig(fri=FriConfig(num_query_rounds=6, proof_of_work_bits=4))
    circuit = make_ecdsa_verification_circuit(msg, sig, pk, config=cfg, n_bits=16)
    lines = _golden_lines("ecdsa_16_test.sha256")
    assert circuit.data.common.n == int(lines[1].split(";")[1].split()[0]) == 8192
    assert tuple(circuit.data.common.circuit_digest) == tuple(int(x) for x in lines[1].split()[1:5])
    proof = circuit.prove()
    assert _sha(proof) == lines[2].split()[0]
    circuit.verify(proof)


@pytest.mark.cuda
@pytest.mark.parametrize("fused_sponge", [False, True])
@pytest.mark.parametrize("d", [2, 4])
def test_sharded_lde_and_tree_at_the_block_shape(card, d, fused_sponge):
    """The block circuit's wire commitment, [135, 2^16] to LDE 2^19, over d
    shards on one card: the LDE equals ``coset_lde`` and every level equals
    ``build_merkle_levels_batch``; each shard's column and row NTTs are one
    launch each (2d against the unsharded LDE's 2)."""
    import importlib

    from intmax_zkp_core_tpu_torch.ops import merkle as mk
    from intmax_zkp_core_tpu_torch.ops import ntt as nt
    from intmax_zkp_core_tpu_torch.parallel.mesh import Mesh, gather

    tns = importlib.import_module("intmax_zkp_core_tpu_torch.parallel.ntt_sharded")
    tms = importlib.import_module("intmax_zkp_core_tpu_torch.parallel.merkle_sharded")
    mesh = Mesh([card] * d)
    coeffs = _rand(120 + d, (135, 1 << 16), card)
    before = pc.launch_counts()["ntt_cuda"]
    parts = tns.coset_lde_sharded(coeffs, 3, mesh)
    assert pc.launch_counts()["ntt_cuda"] == before + 2 * d
    lde = nt.coset_lde(coeffs, 3)
    assert torch.equal(gather(parts, -1, card), lde)
    kernel = "hash_no_pad_cuda" if fused_sponge else "permute_cuda"
    before = pc.launch_counts()[kernel]
    levels = tms.build_merkle_levels_sharded([p.t() for p in parts], 4, mesh,
                                             fused_sponge=fused_sponge)
    assert pc.launch_counts()[kernel] > before
    want = mk.build_merkle_levels_batch(lde.t()[None], 4, fused_sponge=fused_sponge)
    assert len(levels) == len(want)
    for lg, lw in zip(levels, want):
        assert torch.equal(gather(lg, -2, card), lw[0])


@pytest.mark.cuda
def test_mini_recursive_block_over_a_two_shard_mesh(card):
    """``run_mini_recursive_block`` with both shards of its mesh on the card:
    the inner groups over the proof axis and the block proof's commitments
    over the commit mesh give the JAX package's proofs
    (``golden/mini_block_test.sha256``)."""
    from intmax_zkp_core_tpu_torch.models.rollup.mini_block import run_mini_recursive_block
    from intmax_zkp_core_tpu_torch.parallel import merkle_sharded
    from intmax_zkp_core_tpu_torch.parallel.mesh import Mesh

    lines = _golden_lines("mini_block_test.sha256")
    before = merkle_sharded.SHARDED_TREE_CALLS
    r = run_mini_recursive_block(mesh=Mesh([card] * 2))
    assert merkle_sharded.SHARDED_TREE_CALLS >= before + 3
    inner = r["user_tx_proofs"] + r["signature_proofs"] + [r["block_proof"].proof]
    assert [_sha(p) for p in inner] == [ln.split()[0] for ln in lines[1:6]]


@pytest.mark.cuda
def test_prove_batch_over_a_mesh_on_the_card(user_tx_flow):
    """The K = 3 user-tx batch over two shards of one card (padded to 4, one
    lane dropped) equals the flow's proofs."""
    from intmax_zkp_core_tpu_torch.engine.batch_prover import prove_batch
    from intmax_zkp_core_tpu_torch.parallel.mesh import Mesh

    data, pws = user_tx_flow.user_tx_circuit.data, user_tx_flow.user_tx_witnesses
    mesh = Mesh([torch.device("cuda", torch.cuda.current_device())] * 2)
    assert prove_batch(data, pws, mesh=mesh) == user_tx_flow.user_tx_proofs


@pytest.mark.cuda
def test_mesh_over_the_card_and_the_cpu(card):
    """A mesh of two distinct devices, the card and the CPU: the proof axis
    proves on both at once (one host thread each; K = 3 padded to 4 lanes)
    and the commit mesh's exchanges copy between them; the zkDSA proofs
    equal one device's."""
    from intmax_zkp_core_tpu_torch.engine.batch_prover import prove_batch
    from intmax_zkp_core_tpu_torch.engine.config import CircuitConfig
    from intmax_zkp_core_tpu_torch.engine.witness import PartialWitness
    from intmax_zkp_core_tpu_torch.models.zkdsa import make_simple_signature_circuit
    from intmax_zkp_core_tpu_torch.parallel import merkle_sharded
    from intmax_zkp_core_tpu_torch.parallel.mesh import Mesh, use_commit_mesh
    from intmax_zkp_core_tpu_torch.utils.hash_out import HashOut

    circ = make_simple_signature_circuit(CircuitConfig.standard_recursion_config())
    pws = []
    for i in range(3):
        pw = PartialWitness()
        circ.targets.set_witness(pw, HashOut.from_u64(101 + i), HashOut.from_u64(7 + i))
        pws.append(pw)
    single = [circ.data.prove(pw) for pw in pws]
    mesh = Mesh([card, "cpu"])
    assert prove_batch(circ.data, pws, mesh=mesh) == single
    before = merkle_sharded.SHARDED_TREE_CALLS
    with use_commit_mesh(mesh, min_lde=1):
        assert circ.data.prove(pws[0]) == single[0]
    assert merkle_sharded.SHARDED_TREE_CALLS == before + 3


@pytest.mark.cuda
def test_warmup_launches_each_kernel_once(card):
    from intmax_zkp_core_tpu_torch import runtime
    from intmax_zkp_core_tpu_torch.ops import cuda_build as cb

    before = pc.launch_counts()
    seconds = runtime.warmup(max_log_rows=14)
    assert seconds > 0
    launched = {k: n - before[k] for k, n in pc.launch_counts().items()}
    assert launched == {k: {"perm_columns_cuda": pcol.LAUNCHES_PER_CALL, "ntt_cuda": 2}.get(k, 1)
                        for k in cb.LAUNCHES}
