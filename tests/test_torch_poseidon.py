"""Port vs JAX package: Poseidon permutation and sponge hashing.

The JAX side runs as its own CPU tests run it: the plain jnp path, and for
the two Pallas kernels additionally interpret mode at B = 256.  The port
runs on ``device="cpu"`` through the plain versions — including through the
CUDA wrappers, which take the plain version for a CPU tensor.  All ``==``."""

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


def test_permute_matches_jnp_and_scalar():
    x = _states(11, (300, 12))
    want = np.asarray(jps.permute(jnp.asarray(x)))
    got = tgl.to_u64(tps.permute(_t(x)))
    assert (got == want).all()
    for i in (0, 1, 2, 299):
        assert [int(v) for v in got[i]] == tps.permute_s([int(v) for v in x[i]])


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
