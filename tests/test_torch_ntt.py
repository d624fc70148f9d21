"""Port vs JAX package: NTT, inverse NTT, coset LDE and polynomial
evaluation.  Same numpy-seeded inputs through both, ``==`` on u64 values."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from intmax_zkp_core_tpu.ops import ntt as jnt
from intmax_zkp_core_tpu_torch.ops import goldilocks as tgl
from intmax_zkp_core_tpu_torch.ops import ntt as tnt

torch.set_num_threads(1)

P = 0xFFFFFFFF00000001


def _rand(seed, shape):
    a = np.random.default_rng(seed).integers(0, P, size=shape, dtype=np.uint64)
    a.reshape(-1)[0] = 0
    a.reshape(-1)[-1] = P - 1
    return a


@pytest.mark.parametrize("log_n", [3, 4, 7, 10, 12])
def test_ntt_intt_match(log_n):
    a = _rand(log_n, (3, 1 << log_n))
    fwd = np.asarray(jnt.ntt(jnp.asarray(a)))
    assert (tgl.to_u64(tnt.ntt(a, device="cpu")) == fwd).all()
    inv = np.asarray(jnt.intt(jnp.asarray(a)))
    assert (tgl.to_u64(tnt.intt(a, device="cpu")) == inv).all()
    # round trip on the port's side
    back = tnt.intt(tnt.ntt(tgl.from_u64(a, "cpu")))
    assert (tgl.to_u64(back) == a).all()


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
