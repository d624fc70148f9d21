"""Port vs JAX package: Poseidon permutation and sponge hashing.

The JAX side runs as its own CPU tests run it: the plain jnp path, and for
the two Pallas kernels additionally interpret mode at B = 256.  The port
runs on ``device="cpu"`` through the plain versions — including through the
CUDA wrappers, which take the plain version for a CPU tensor.  All ``==``."""

import functools

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from intmax_zkp_core_tpu.ops import poseidon as jps
from intmax_zkp_core_tpu_torch.ops import goldilocks as tgl
from intmax_zkp_core_tpu_torch.ops import poseidon as tps
from intmax_zkp_core_tpu_torch.ops import poseidon_cuda as tpc
from intmax_zkp_core_tpu_torch.ops.poseidon_constants import REFERENCE_GOLDEN_ZERO_DIGEST

torch.set_num_threads(1)

P = 0xFFFFFFFF00000001


def _states(seed, shape):
    rng = np.random.default_rng(seed)
    x = rng.integers(0, P, size=shape, dtype=np.uint64)
    x[0] = 0
    x[1] = P - 1
    x[2, : shape[1] // 2] = 0xFFFFFFFF
    return x


def _t(a):
    return tgl.from_u64(a, "cpu")


M64 = (1 << 64) - 1
EPS = 0xFFFFFFFF


def _noncanonical_states(seed, rows):
    """``_states`` with a third of the lanes of rows 4.. in [p, 2^64), and row
    3 holding 0, p - 1, p and 2^64 - 1."""
    rng = np.random.default_rng(seed + 1000)
    x = _states(seed, (rows, 12))
    high = rng.integers(P, M64, size=(rows, 12), dtype=np.uint64, endpoint=True)
    pick = rng.random((rows, 12)) < 1 / 3
    pick[:4] = False
    x[pick] = high[pick]
    x[3] = [0, P - 1, P, M64] * 3
    return x


@functools.lru_cache(maxsize=None)
def _jnp_permuted(seed):
    """300 rows of ``_noncanonical_states`` and their JAX permutation (one
    eager JAX call, shared by the tests that compare against it)."""
    x = _noncanonical_states(seed, 300)
    return x, np.asarray(jps.permute(jnp.asarray(x)))


def test_permute_matches_jnp_and_scalar():
    x, want = _jnp_permuted(11)
    got = tgl.to_u64(tps.permute(_t(x)))
    assert (got == want).all()
    for i in (0, 1, 2, 299):
        assert [int(v) for v in got[i]] == tps.permute_s([int(v) for v in x[i]])


# The kernel's loose arithmetic in Python ints, function by function as in
# csrc/goldilocks.cuh and csrc/poseidon.cu: every value below 2^64 (asserted)
# but not reduced below p until the output.


def _reduce128(x):  # gl_reduce128_loose
    assert 0 <= x < 1 << 128
    lo, hi_lo, hi_hi = x & M64, (x >> 64) & EPS, x >> 96
    k, r = divmod(lo + (hi_lo << 32) - hi_lo - hi_hi, 1 << 64)
    assert k in (-1, 0, 1)
    r += k * EPS
    assert 0 <= r <= M64 and r % P == x % P
    return r


def _reduce160(x):  # GlDot::hi_lo + gl_reduce160_loose
    assert 0 <= x < 1 << 160
    r, t = _reduce128(x & ((1 << 128) - 1)), (x >> 128) << 32
    d = (r - t) & M64
    if r < t:
        d -= EPS
    assert 0 <= d <= M64 and d % P == x % P
    return d


def _add(a, c):  # gl_add_loose: a loose, c canonical
    assert c < P
    s = a + c
    if s > M64:
        s = (s & M64) + EPS
    assert s <= M64
    return s


def _sbox(x):  # gl_sbox7_loose
    x3 = _reduce128(_reduce128(x * x) * x)
    return _reduce128(_reduce128(x3 * x3) * x)


def _mds_fold(s, fold):  # poseidon.cu::mds_fold over poseidon_round.cuh::mds_row
    from intmax_zkp_core_tpu_torch.ops.poseidon_constants import MDS_MATRIX_CIRC, MDS_MATRIX_DIAG

    out = []
    for r in range(12):
        acc_lo = sum(MDS_MATRIX_CIRC[i] * (s[(r + i) % 12] & EPS) for i in range(12))
        acc_hi = sum(MDS_MATRIX_CIRC[i] * (s[(r + i) % 12] >> 32) for i in range(12))
        if r == 0:
            acc_lo += MDS_MATRIX_DIAG[0] * (s[0] & EPS)
            acc_hi += MDS_MATRIX_DIAG[0] * (s[0] >> 32)
        assert acc_lo < 1 << 41 and acc_hi < 1 << 41
        n2, n = divmod(acc_lo + (acc_hi << 32) + fold[r], 1 << 64)  # gl_fold_reduce_loose
        k, x = divmod(n + (n2 << 32) - n2, 1 << 64)
        assert k in (0, 1)
        x += k * EPS
        assert x <= M64
        out.append(x)
    return out


def _replay_permute(s, tables):  # poseidon.cu::permute_loose
    full, init, sparse = tables["full_rc"], tables["init"], tables["sparse"]
    for half in range(2):
        c = full[half * 60 : (half + 1) * 60]
        s = [_add(x, c[i]) for i, x in enumerate(s)]
        for rnd in range(1, 5):
            s = _mds_fold([_sbox(x) for x in s], c[rnd * 12 : (rnd + 1) * 12])
        if half == 0:  # partial_rounds
            s = [s[0]] + [
                _reduce160(sum(init[i * 11 + j] * s[1 + j] for j in range(11))) for i in range(11)
            ]
            for rnd in range(22):
                c = sparse[rnd * 24 : (rnd + 1) * 24]
                s0 = _add(_sbox(s[0]), c[0])
                new0 = _reduce160(c[1] * s0 + sum(c[2 + j] * s[1 + j] for j in range(11)))
                s = [new0] + [_reduce128(c[13 + j] * s0 + s[1 + j]) for j in range(11)]
    return s


def _canon(x):  # gl_canon
    return x - P if x >= P else x


def test_kernel_tables_replayed_in_kernel_order():
    """The upload arrays of ``poseidon_cuda._ready`` replayed in Python ints
    in the kernel's order (folded constants, sparse partial rounds, loose
    state, one canonicalisation per output lane) equal ``permute_s``, the
    port's and the JAX package's permutation, on inputs with lanes in
    [p, 2^64); and the sponge (loose capacity lanes between absorb steps,
    partial last chunks) equals ``hash_no_pad_s``.  Tolerance 0."""
    tables = tpc.kernel_tables()
    x, want = _jnp_permuted(11)
    for row in (0, 1, 3, 4, 299):
        got = [_canon(v) for v in _replay_permute([int(v) for v in x[row]], tables)]
        assert got == [int(v) for v in want[row]] == tps.permute_s([int(v) for v in x[row]])
    for width in (1, 9):
        row = [int(v) for v in x[7 + width].tolist() + x[8 + width].tolist()][:width]
        s = [0] * 12
        for start in range(0, width, 8):
            chunk = row[start : start + 8]
            s[: len(chunk)] = chunk
            s = _replay_permute(s, tables)
        assert [_canon(v) for v in s[:4]] == tps.hash_no_pad_s(row)


def test_permute_matches_pallas_interpret():
    from intmax_zkp_core_tpu.ops.poseidon_pallas import permute_pallas

    x = _states(12, (256, 12))
    want = np.asarray(permute_pallas(jnp.asarray(x), True))
    before = tpc.launch_counts()
    got = tgl.to_u64(tpc.permute_cuda(_t(x)))  # CPU tensor -> plain version
    assert (got == want).all()
    assert tpc.launch_counts() == before  # no kernel launch was counted


def test_fused_sponge_matches_pallas_interpret():
    from intmax_zkp_core_tpu.ops.poseidon_pallas import hash_no_pad_pallas

    x = _states(13, (256, 15))
    want = np.asarray(hash_no_pad_pallas(jnp.asarray(x), True))
    got = tgl.to_u64(tpc.hash_no_pad_cuda(_t(x)))
    assert (got == want).all()
    # a transposed view hashes to the same digests (strides, not copies)
    xt = _t(np.ascontiguousarray(x.T)).t()
    assert (tgl.to_u64(tpc.hash_no_pad_cuda(xt)) == want).all()


@pytest.mark.parametrize("width", [2, 8, 12, 135])
def test_hash_no_pad_matches(width):
    x = _states(20 + width, (64, width))
    want = np.asarray(jps.hash_no_pad(jnp.asarray(x)))
    assert (tgl.to_u64(tps.hash_no_pad(_t(x))) == want).all()
    assert (tgl.to_u64(tps.hash_no_pad(_t(x), fused_sponge=True)) == want).all()
    assert (tgl.to_u64(tpc.hash_no_pad_plain(_t(x))) == want).all()
    assert [int(v) for v in want[5]] == tps.hash_no_pad_s([int(v) for v in x[5]])


def test_hash_pad_two_to_one_match():
    x = _states(31, (32, 8))
    assert (tgl.to_u64(tps.hash_pad(_t(x))) == np.asarray(jps.hash_pad(jnp.asarray(x)))).all()
    left, right = x[:, :4], x[:, 4:]
    want = np.asarray(jps.two_to_one(jnp.asarray(left), jnp.asarray(right)))
    assert (tgl.to_u64(tps.two_to_one(_t(left), _t(right))) == want).all()
    assert [int(v) for v in want[3]] == tps.two_to_one_s(left[3], right[3])


def test_scalar_functions_match():
    rng = np.random.default_rng(32)
    for n in (1, 7, 8, 9, 20):
        xs = [int(v) for v in rng.integers(0, P, size=n, dtype=np.uint64)]
        assert tps.hash_no_pad_s(xs) == [int(v) for v in jps.hash_no_pad_s(xs)]
        assert tps.hash_pad_s(xs) == [int(v) for v in jps.hash_pad_s(xs)]
    st = [int(v) for v in rng.integers(0, P, size=12, dtype=np.uint64)]
    assert tps.permute_s(st) == jps.permute_s(st)


def test_zero_digest_anchor():
    # Poseidon(0 || 0): the reference's golden digest
    z = torch.zeros((1, 12), dtype=torch.int64)
    assert tuple(int(v) for v in tgl.to_u64(tps.permute(z))[0, :4]) == REFERENCE_GOLDEN_ZERO_DIGEST
    assert tuple(tps.two_to_one_s([0] * 4, [0] * 4)) == REFERENCE_GOLDEN_ZERO_DIGEST


def test_wrappers_reject_bad_arguments():
    with pytest.raises(TypeError):
        tpc.permute_cuda(torch.zeros((4, 12), dtype=torch.int32))
    with pytest.raises(ValueError):
        tpc.permute_cuda(torch.zeros((4, 11), dtype=torch.int64))
    with pytest.raises(ValueError):
        tpc.hash_no_pad_cuda(torch.zeros((4, 3, 8), dtype=torch.int64))


def test_cpu_blocks_give_the_whole_batch(monkeypatch):
    """On the CPU the plain permutation runs its rows in blocks of
    ``CPU_BLOCK_STATES``; blocks of 5 states over 37 rows, noncanonical
    lanes among them, give the unblocked batch and the exact Python
    permutation."""
    x = _t(_noncanonical_states(21, 37))
    whole = tps._permute_block(x)
    monkeypatch.setattr(tps, "CPU_BLOCK_STATES", 5)
    assert torch.equal(tps.permute(x), whole)
    assert torch.equal(tps.permute(x.reshape(37, 1, 12)), whole.reshape(37, 1, 12))
    want = [tps.permute_s([int(v) for v in row]) for row in tgl.to_u64(x[:4])]
    assert tgl.to_u64(whole[:4]).tolist() == want
