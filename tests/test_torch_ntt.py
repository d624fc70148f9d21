"""Port vs JAX package: NTT, inverse NTT, coset LDE and polynomial
evaluation.  Same numpy-seeded inputs through both, ``==`` on u64 values.

``ntt``/``intt`` of the port go through the wrapper of the NTT kernel
(``ops/ntt_cuda.py::ntt_cuda``), which takes the plain version for a tensor on
the CPU; the JAX side runs its XLA NTT and, once each way at 2^14, its Pallas
four-step kernel in interpret mode."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from intmax_zkp_core_tpu.ops import ntt as jnt
from intmax_zkp_core_tpu_torch.ops import goldilocks as tgl
from intmax_zkp_core_tpu_torch.ops import ntt as tnt
from intmax_zkp_core_tpu_torch.ops import ntt_cuda as tnc

torch.set_num_threads(1)

P = 0xFFFFFFFF00000001


def _rand(seed, shape):
    a = np.random.default_rng(seed).integers(0, P, size=shape, dtype=np.uint64)
    a.reshape(-1)[0] = 0
    a.reshape(-1)[-1] = P - 1
    return a


@pytest.mark.parametrize("log_n", range(1, 13))
def test_ntt_intt_match(log_n):
    a = _rand(log_n, (3, 1 << log_n))
    before = tnc.cb.launch_counts()
    fwd = np.asarray(jnt.ntt(jnp.asarray(a)))
    assert (tgl.to_u64(tnt.ntt(a, device="cpu")) == fwd).all()
    inv = np.asarray(jnt.intt(jnp.asarray(a)))
    assert (tgl.to_u64(tnt.intt(a, device="cpu")) == inv).all()
    # round trip on the port's side
    back = tnt.intt(tnt.ntt(tgl.from_u64(a, "cpu")))
    assert (tgl.to_u64(back) == a).all()
    assert tnc.cb.launch_counts() == before  # CPU tensors launch nothing


@pytest.mark.parametrize("inverse", [False, True])
def test_ntt_matches_pallas_four_step_interpret(inverse):
    from intmax_zkp_core_tpu.ops.ntt_pallas import ntt_pallas

    a = _rand(80 + inverse, (1, 1 << 14))
    want = np.asarray(ntt_pallas(jnp.asarray(a), inverse, True))
    got = tnc.ntt_cuda(tgl.from_u64(a, "cpu"), inverse)
    assert (tgl.to_u64(got) == want).all()


def test_fourstep_twiddles_and_launch_plan():
    # the kernel's four-step table w^(i2 * k1) (inverse: w^-(i2 * k1) / n)
    # against exact integers, and one launch up to 2^11, two above
    log_n1, log_n2 = 3, 4
    n = 1 << (log_n1 + log_n2)
    w = tgl.primitive_root_of_unity(log_n1 + log_n2)
    for inverse in (False, True):
        root = pow(w, P - 2, P) if inverse else w
        scale = pow(n, P - 2, P) if inverse else 1
        got = tgl.to_u64(tnc.fourstep_twiddles(log_n1, log_n2, inverse, torch.device("cpu")))
        want = [[scale * pow(root, k1 * i2, P) % P for i2 in range(1 << log_n2)]
                for k1 in range(1 << log_n1)]
        assert got.tolist() == want
    assert [tnc.launches_for(1 << k) for k in (0, 1, 11, 12, 22)] == [1, 1, 1, 2, 2]


def test_ntt_wrapper_rejects_bad_arguments():
    with pytest.raises(ValueError):
        tnc.ntt_cuda(torch.zeros((2, 12), dtype=torch.int64))  # not a power of two
    with pytest.raises(ValueError):
        tnc.ntt_cuda(torch.zeros((2, 2, 8), dtype=torch.int64))  # not [B, n]
    with pytest.raises(TypeError):
        tnc.ntt_cuda(torch.zeros((2, 8), dtype=torch.int32))


def test_ntt_definition_small():
    a = _rand(50, (8,))
    w = tgl.primitive_root_of_unity(3)
    want = [sum(int(a[j]) * pow(w, i * j, P) for j in range(8)) % P for i in range(8)]
    assert [int(v) for v in tgl.to_u64(tnt.ntt(a, device="cpu"))] == want


@pytest.mark.parametrize("log_n,rate_bits", [(3, 3), (6, 3), (9, 2)])
def test_coset_lde_ilde_match(log_n, rate_bits):
    a = _rand(60 + log_n, (2, 1 << log_n))
    want = np.asarray(jnt.coset_lde(jnp.asarray(a), rate_bits))
    got = tnt.coset_lde(a, rate_bits, device="cpu")
    assert (tgl.to_u64(got) == want).all()
    back = np.asarray(jnt.coset_ilde(jnp.asarray(want), rate_bits))
    assert (tgl.to_u64(tnt.coset_ilde(got, rate_bits)) == back).all()
    assert (back == a).all()
    # a non-default shift (FRI's squared shifts)
    want49 = np.asarray(jnt.coset_ilde(jnp.asarray(want), rate_bits, 49))
    assert (tgl.to_u64(tnt.coset_ilde(got, rate_bits, 49)) == want49).all()


def test_eval_poly_match():
    coeffs = _rand(70, (5, 16))
    x = _rand(71, (5,))
    want = np.asarray(jnt.eval_poly_at(jnp.asarray(coeffs), jnp.asarray(x)))
    got = tnt.eval_poly_at(tgl.from_u64(coeffs, "cpu"), tgl.from_u64(x, "cpu"))
    assert (tgl.to_u64(got) == want).all()
    xe = _rand(72, (2,))
    want_e = np.asarray(jnt.eval_poly_at_ext(jnp.asarray(coeffs), jnp.asarray(xe)))
    got_e = tnt.eval_poly_at_ext(tgl.from_u64(coeffs, "cpu"), tgl.from_u64(xe, "cpu"))
    assert (tgl.to_u64(got_e) == want_e).all()
