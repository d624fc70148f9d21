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


# The kernel's order (csrc/perm_quotient.cu) in Python ints: one "thread"
# per (proof, point) with all challenges, the loose fused factors and chunk
# products of goldilocks.cuh and perm_chunk.cuh (every value asserted below 2^64 by the
# helpers), and each challenge's alpha fold as ONE unreduced sum of products
# (asserted below 2^160 with a top word below 2^32), reduced once.
from test_torch_gate_quotient import _add, _canon, _reduce128, _reduce_dot, _sub  # noqa: E402

EDGE_LANES = (0, 1, (1 << 32) - 1, 1 << 32, 1 << 63, P - 1)


def _mul(a, b):  # gl_mul_loose / gl_sqr_loose
    assert 0 <= a < 1 << 64 and 0 <= b < 1 << 64
    return _reduce128(a * b)


def _chain(facs):  # perm_chunk.cuh::chunk_product: left to right, loose
    p = facs[0]
    for u in facs[1:]:
        p = _mul(p, u)
    return p


def _replay_point(d, k, t, blowup):
    """perm_quotient_kernel<C> at proof k, point t -> (acc [C], apows [C])."""
    K, C, L = d["zs_lde"].shape
    R = d["sigma_lde"].shape[0]
    nch = (R + 6) // 7
    v = lambda name, *idx: int(d[name][idx])  # noqa: E731
    x, l0 = v("xs", t), v("l0", t)
    accs, apows = [], []
    for c in range(C):  # the block's tables: the left fold of alpha, beta * k_i
        beta, gamma, alpha = v("betas", k, c), v("gammas", k, c), v("alphas", k, c)
        apow = [1]
        for _ in range(nch + 1):
            apow.append(apow[-1] * alpha % P)
        apows.append(apow.pop())
        bk = [beta * v("k_is", i) % P for i in range(R)]
        prev = v("zs_lde", k, c, t)
        terms = [(l0, _sub(prev, 1))]  # alpha^0 = 1
        for j in range(nch):  # fused multiply-adds, w_i + gamma shared by f_i and g_i
            rows = range(7 * j, min(7 * j + 7, R))
            wg = [_add(v("wires_lde", k, i, t), gamma) for i in rows]
            f = _chain([_reduce128(bk[i] * x + u) for i, u in zip(rows, wg)])
            g = _chain([_reduce128(beta * v("sigma_lde", i, t) + u) for i, u in zip(rows, wg)])
            nxt = v("zs_lde", k, c, (t + blowup) % L) if j == nch - 1 else v("pps_lde", k, c, j, t)
            terms.append((apow[j + 1], _sub(_mul(nxt, g), _canon(_mul(prev, f)))))
            prev = nxt
        accs.append(_canon(_reduce_dot(terms)))
    return accs, apows


def _edge(d, seed):
    """The inputs with their lanes run through 0, 1, 2^32 - 1, 2^32, 2^63 and
    p - 1."""
    rng = np.random.default_rng(seed)
    out = {}
    for name, a in d.items():
        a = a.copy()
        flat = a.reshape(-1)
        for i, v in enumerate(EDGE_LANES):
            flat[int(rng.integers(0, 5)) + i :: 7 * len(EDGE_LANES)] = v
        out[name] = a
    return out


@pytest.mark.parametrize("C_,R", [(1, 23), (2, 80), (3, 5)])
def test_kernel_order_replayed_in_python_ints(C_, R):
    # K = 2 proofs, all C challenges per point, on edge lanes; the points
    # include the last ones, whose Z(x * omega) wraps around
    d = _edge(_inputs(R, K=2, seed=50 + C_), 51 + C_)
    d["zs_lde"], d["pps_lde"] = d["zs_lde"][:, :1].repeat(C_, 1), d["pps_lde"][:, :1].repeat(C_, 1)
    for c in range(1, C_):  # distinct challenges
        d["zs_lde"][:, c] = np.roll(d["zs_lde"][:, c], c, axis=-1)
        d["pps_lde"][:, c] = np.roll(d["pps_lde"][:, c], c, axis=-1)
    rng = np.random.default_rng(52 + C_)
    for name in ("betas", "gammas", "alphas"):
        d[name] = rng.integers(0, P, size=(2, C_), dtype=np.uint64)
    acc, apows = (gl.to_u64(a) for a in pq.perm_quotient_plain(**_t(d), blowup=BLOWUP))
    for k in range(2):
        for t in (0, 1, 17, L - BLOWUP, L - 1):
            got_acc, got_apows = _replay_point(d, k, t, BLOWUP)
            assert got_acc == [int(a) for a in acc[k, :, t]]
            assert got_apows == [int(a) for a in apows[k]]
    assert acc.max() < P
