"""The CUDA kernels of the port against their plain PyTorch versions, on the
card.  A CUDA kernel has no interpret mode, so these tests need an NVIDIA GPU
and nvcc; without a CUDA device they skip.  Run them on the GPU machine with

    python -m pytest tests/test_torch_cuda.py -q -m cuda

(``python3 chip_smoke.py`` makes the same comparisons at more shapes and
drives a whole proof)."""

import numpy as np
import pytest
import torch

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
@pytest.mark.parametrize("C", [1, 3, 4])
def test_poseidon_gate_quotient_cuda_every_challenge_count(card, C):
    K, L = 2, 1000  # L not a multiple of the kernel's block of points
    args = [_edge(70, (K, 135, L), card), _edge(71, (L,), card), _edge(72, (K, C), card),
            _edge(73, (K, C, L), card), _edge(74, (K, C), card)]
    before = pc.launch_counts()["poseidon_gate_quotient_cuda"]
    acc, apows = gqc.poseidon_gate_quotient_cuda(*args)
    assert pc.launch_counts()["poseidon_gate_quotient_cuda"] == before + 1
    want_acc, want_apows = gqc.poseidon_gate_quotient_plain(*args)
    assert torch.equal(acc, want_acc) and torch.equal(apows, want_apows)
    assert _canonical(acc) and _canonical(apows)


@pytest.mark.cuda
def test_ntt_and_gate_wrappers_never_take_the_plain_path_for_a_cuda_tensor(card):
    x = _rand(50, (8, 64), card)
    with pytest.raises(ValueError):
        nc.ntt_cuda(x.t(), False)  # strided rows
    with pytest.raises(ValueError):
        nc.ntt_cuda(_rand(51, (1, 1 << 23), card), False)  # above the stated limit
    args = [_rand(52, (1, 135, 64), card), _rand(53, (64,), card), _rand(54, (1, 5), card),
            _rand(55, (1, 5, 64), card), _rand(56, (1, 5), card)]
    with pytest.raises(ValueError):
        gqc.poseidon_gate_quotient_cuda(*args)  # C = 5 above the kernel's four
