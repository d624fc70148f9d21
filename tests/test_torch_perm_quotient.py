"""K5 and K6, the permutation terms of the quotient and the divide by Z_H,
and the Fermat inverse under them: the port's plain versions against the JAX
package, bit for bit.

K5: ``perm_quotient_jnp_limb`` (the Pallas kernel's tile computation run
eagerly, as the JAX package's own CPU test runs it) against
``perm_quotient_plain`` / ``perm_quotient_cuda``.  K6: ``gl.mul(acc,
gl.inv(z_h))`` of the JAX package against ``zinv_mul_plain``.  ``inv``:
``limb64.inv`` (the addition chain the CUDA header's ``gl_inv`` follows)
against the port's ``gl.inv`` (square-and-multiply) on 0, 1, p-1 and random
lanes.  On the CPU a wrapper takes its plain version.  Tolerance 0."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from intmax_zkp_core_tpu.ops import goldilocks as jgl
from intmax_zkp_core_tpu.ops import limb64
from intmax_zkp_core_tpu.ops.perm_quotient_pallas import perm_quotient_jnp_limb
from intmax_zkp_core_tpu_torch.ops import goldilocks as gl
from intmax_zkp_core_tpu_torch.ops import perm_quotient_cuda as pq
from intmax_zkp_core_tpu_torch.ops import zinv_mul_cuda as zm

torch.set_num_threads(1)

P = gl.P_INT
L, C, BLOWUP = 64, 2, 8


def _inputs(R, K=1, seed=17):
    rng = np.random.default_rng(seed + R)
    nch = (R + 6) // 7
    field = lambda *shape: rng.integers(0, P, size=shape, dtype=np.uint64)  # noqa: E731
    wires = field(K, R + 3, L)  # extra rows are ignored
    wires.reshape(-1)[::7] = 0
    wires.reshape(-1)[3::11] = P - 1
    return {
        "wires_lde": wires, "zs_lde": field(K, C, L), "pps_lde": field(K, C, nch - 1, L),
        "betas": field(K, C), "gammas": field(K, C), "alphas": field(K, C),
        "sigma_lde": field(R, L), "xs": field(L), "l0": field(L), "k_is": field(R),
    }


def _t(d):
    return {k: gl.from_u64(v, "cpu") for k, v in d.items()}


@pytest.mark.parametrize("R", [3, 7, 16, 23])
def test_perm_quotient_plain_equals_jax(R):
    d = _inputs(R)
    jacc, japows = perm_quotient_jnp_limb(
        *(jnp.asarray(d[k][0]) for k in ("wires_lde", "zs_lde", "pps_lde", "betas", "gammas", "alphas")),
        jnp.asarray(d["sigma_lde"]), jnp.asarray(d["xs"]), jnp.asarray(d["l0"]), d["k_is"], BLOWUP,
    )
    acc, apows = pq.perm_quotient_plain(**_t(d), blowup=BLOWUP)
    assert acc.shape == (1, C, L) and apows.shape == (1, C)
    assert np.array_equal(gl.to_u64(acc[0]), np.asarray(jacc))
    assert np.array_equal(gl.to_u64(apows[0]), np.asarray(japows))


@pytest.mark.parametrize("R", [3, 7, 16, 23])
def test_perm_quotient_wrapper_on_cpu_takes_the_plain_version_and_batches(R):
    d = _inputs(R, K=2)
    before = pq.cb.launch_counts()
    acc, apows = pq.perm_quotient_cuda(**_t(d), blowup=BLOWUP)
    assert pq.cb.launch_counts() == before  # a CPU tensor launches nothing
    per_proof = ("wires_lde", "zs_lde", "pps_lde", "betas", "gammas", "alphas")
    for k in range(2):
        one = {key: (v[k : k + 1] if key in per_proof else v) for key, v in d.items()}
        acc_k, apows_k = pq.perm_quotient_plain(**_t(one), blowup=BLOWUP)
        assert torch.equal(acc[k], acc_k[0]) and torch.equal(apows[k], apows_k[0])


def test_perm_quotient_wrapper_refuses_what_the_kernel_cannot_take():
    d = _t(_inputs(7))
    with pytest.raises(TypeError):
        pq.perm_quotient_cuda(**{**d, "xs": d["xs"].to(torch.int32)}, blowup=BLOWUP)
    with pytest.raises(ValueError):
        pq.perm_quotient_cuda(**{**d, "l0": d["l0"][:8]}, blowup=BLOWUP)
    with pytest.raises(ValueError):
        pq.perm_quotient_cuda(**{**d, "wires_lde": d["wires_lde"][:, :5]}, blowup=BLOWUP)


def _lanes(seed, shape):
    a = np.random.default_rng(seed).integers(0, P, size=shape, dtype=np.uint64)
    a.reshape(-1)[:3] = [0, 1, P - 1]
    return a


@pytest.mark.parametrize("rows", [(), (1,), (4,), (2, 3)], ids=str)
def test_zinv_mul_plain_equals_jax(rows):
    acc, z_h = _lanes(5, rows + (L,)), _lanes(6, (L,))
    want = np.asarray(jgl.mul(jnp.asarray(acc), jgl.inv(jnp.asarray(z_h))))
    before = zm.cb.launch_counts()
    got = zm.zinv_mul_cuda(gl.from_u64(acc, "cpu"), gl.from_u64(z_h, "cpu"))
    assert zm.cb.launch_counts() == before
    assert np.array_equal(gl.to_u64(got), want)
    assert torch.equal(got, zm.zinv_mul_plain(gl.from_u64(acc, "cpu"), gl.from_u64(z_h, "cpu")))


def test_zinv_mul_wrapper_refuses_what_the_kernel_cannot_take():
    acc, z_h = gl.from_u64(_lanes(5, (2, L)), "cpu"), gl.from_u64(_lanes(6, (L,)), "cpu")
    with pytest.raises(TypeError):
        zm.zinv_mul_cuda(acc.to(torch.int32), z_h)
    with pytest.raises(ValueError):
        zm.zinv_mul_cuda(acc, z_h[:8])


def test_inv_square_and_multiply_equals_the_addition_chain():
    x = _lanes(7, (256,))
    lo, hi = limb64.inv(
        jnp.asarray((x & np.uint64(0xFFFFFFFF)).astype(np.uint32)),
        jnp.asarray((x >> np.uint64(32)).astype(np.uint32)),
    )
    chain = np.asarray(lo).astype(np.uint64) | (np.asarray(hi).astype(np.uint64) << np.uint64(32))
    got = gl.to_u64(gl.inv(gl.from_u64(x, "cpu")))
    assert np.array_equal(got, chain)
    assert [int(v) for v in got[:3]] == [0, 1, P - 1]
    for a, b in zip(x[3:19], got[3:19]):
        assert int(a) * int(b) % P == 1
