"""K7, the initial FRI evaluation vector G: the port's plain version against
the JAX package's eager limb twin of its Pallas kernel, bit for bit.

Same inputs from a numpy seed through ``fri_initial_jnp_limb`` (the tile
computation of the Pallas kernel run eagerly, as the JAX package's own CPU
test runs it) and through ``fri_initial_plain`` / ``fri_initial_cuda`` of the
port (on the CPU the wrapper takes the plain version).  Tolerance 0."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from intmax_zkp_core_tpu.ops.fri_init_pallas import fri_initial_jnp_limb
from intmax_zkp_core_tpu_torch.ops import fri_init_cuda as fi
from intmax_zkp_core_tpu_torch.ops import goldilocks as gl

torch.set_num_threads(1)

P = gl.P_INT
NAMES = ("comb1", "comb2", "xs", "zetas", "gzetas", "c1z", "c2gz")


def _inputs(L, K=1, seed=29):
    rng = np.random.default_rng(seed + L)
    d = {
        "comb1": rng.integers(0, P, size=(K, L, 2), dtype=np.uint64),
        "comb2": rng.integers(0, P, size=(K, L, 2), dtype=np.uint64),
        "xs": rng.integers(1, P, size=(L,), dtype=np.uint64),
    }
    for name in NAMES[3:]:
        d[name] = rng.integers(0, P, size=(K, 2), dtype=np.uint64)
    d["comb1"].reshape(-1)[::7] = 0  # lanes of 0 and p-1
    d["comb2"].reshape(-1)[3::11] = P - 1
    return d


def _t(d):
    return [gl.from_u64(d[name], "cpu") for name in NAMES]


@pytest.mark.parametrize("L", [8, 64, 136])
def test_fri_initial_plain_equals_jax(L):
    d = _inputs(L)
    want = np.asarray(fri_initial_jnp_limb(
        jnp.asarray(d["comb1"][0]), jnp.asarray(d["comb2"][0]), jnp.asarray(d["xs"]),
        *(jnp.asarray(d[name][0]) for name in NAMES[3:]),
    ))
    got = fi.fri_initial_plain(*_t(d))
    assert got.shape == (1, L, 2)
    assert np.array_equal(gl.to_u64(got[0]), want)


def test_fri_initial_with_a_base_field_zeta_and_a_point_on_the_domain():
    # z1 = 0 and x = z0: the norm is 0, the inverse maps it to 0 on both sides
    d = _inputs(64)
    d["zetas"][0] = (d["xs"][5], 0)
    want = np.asarray(fri_initial_jnp_limb(
        jnp.asarray(d["comb1"][0]), jnp.asarray(d["comb2"][0]), jnp.asarray(d["xs"]),
        *(jnp.asarray(d[name][0]) for name in NAMES[3:]),
    ))
    assert np.array_equal(gl.to_u64(fi.fri_initial_plain(*_t(d))[0]), want)


@pytest.mark.parametrize("L", [8, 64])
def test_wrapper_on_cpu_takes_the_plain_version_and_batches(L):
    d = _inputs(L, K=2)
    before = fi.cb.launch_counts()
    got = fi.fri_initial_cuda(*_t(d))
    assert fi.cb.launch_counts() == before  # a CPU tensor launches nothing
    for k in range(2):
        one = {name: (v if name == "xs" else v[k : k + 1]) for name, v in d.items()}
        assert torch.equal(got[k], fi.fri_initial_plain(*_t(one))[0])


def test_wrapper_refuses_what_the_kernel_cannot_take():
    comb1, comb2, xs, zetas, gzetas, c1z, c2gz = _t(_inputs(8))
    with pytest.raises(TypeError):
        fi.fri_initial_cuda(comb1.to(torch.int32), comb2, xs, zetas, gzetas, c1z, c2gz)
    with pytest.raises(ValueError):
        fi.fri_initial_cuda(comb1, comb2[:, :4], xs, zetas, gzetas, c1z, c2gz)
    with pytest.raises(ValueError):
        fi.fri_initial_cuda(comb1, comb2, xs, zetas[0], gzetas, c1z, c2gz)


# The kernel's schedule (csrc/fri_init.cu) in Python ints: each thread's
# points, one block width apart, the two norms of all a block's points
# inverted in one batch (goldilocks.cuh::batch_inv_loose, one chain a block),
# each output lane one unreduced sum of four products reduced once; the loose
# arithmetic of goldilocks.cuh, every value asserted below 2^64 by the
# helpers.
from test_torch_gate_quotient import _canon, _reduce_dot, _sub  # noqa: E402
from test_torch_perm_quotient import EDGE_LANES, _batch_inv, _blocks, _mul  # noqa: E402


def _replay(d, threads, warp, points):
    K, L = d["comb1"].shape[:2]
    v = lambda name, *idx: int(d[name][idx])  # noqa: E731
    out = np.zeros((K, L, 2), dtype=np.uint64)
    for k in range(K):
        za0, za1, zb0, zb1 = v("zetas", k, 0), v("zetas", k, 1), v("gzetas", k, 0), v("gzetas", k, 1)
        wa, wb = _canon(_mul(_mul(za1, za1), 7)), _canon(_mul(_mul(zb1, zb1), 7))
        sa, sb = _mul(za1, 7), _mul(zb1, 7)
        ca0, ca1, cb0, cb1 = v("c1z", k, 0), v("c1z", k, 1), v("c2gz", k, 0), v("c2gz", k, 1)
        for block in _blocks(L, threads, points):
            norms = []
            for ts in block:  # each thread's norms of terms a and b, point by point
                norms.append([])
                for t in ts:
                    x = v("xs", t) if t < L else 0
                    da, db = _sub(x, za0), _sub(x, zb0)
                    norms[-1] += [_sub(_mul(da, da), wa), _sub(_mul(db, db), wb)] if t < L else [1, 1]
            for ts, inv in zip(block, _batch_inv(norms, warp)):
                for i, t in enumerate(ts):
                    if t >= L:
                        continue
                    x = v("xs", t)
                    da, db = _sub(x, za0), _sub(x, zb0)
                    na0, na1 = _sub(v("comb1", k, t, 0), ca0), _sub(v("comb1", k, t, 1), ca1)
                    nb0, nb1 = _sub(v("comb2", k, t, 0), cb0), _sub(v("comb2", k, t, 1), cb1)
                    ia0, ia1 = _mul(da, inv[2 * i]), _mul(za1, inv[2 * i])
                    ib0, ib1 = _mul(db, inv[2 * i + 1]), _mul(zb1, inv[2 * i + 1])
                    g0 = _reduce_dot([(na0, ia0), (na1, _mul(sa, inv[2 * i])), (nb0, ib0),
                                      (nb1, _mul(sb, inv[2 * i + 1]))])
                    g1 = _reduce_dot([(na0, ia1), (na1, ia0), (nb0, ib1), (nb1, ib0)])
                    out[k, t] = (_canon(g0), _canon(g1))
    return out


@pytest.mark.parametrize("threads,warp,points,L", [(8, 4, 3, 61), (4, 2, 2, 37)])
def test_kernel_schedule_replayed_in_python_ints(threads, warp, points, L):
    # K = 3 proofs on edge lanes, partial last blocks; proof k's zeta lies in
    # the base field on xs at the first (k = 0), a middle (1) or the last (2)
    # point of one thread, and its g*zeta likewise on another thread's, so
    # that one term of that point has a zero norm
    d = _inputs(L, K=3, seed=70)
    rng = np.random.default_rng(71)
    for name, a in d.items():  # xs once each: the points of a domain are distinct
        flat = a.reshape(-1)
        for i, e in enumerate(EDGE_LANES):
            flat[int(rng.integers(0, 5)) + i :: L if name == "xs" else 7 * len(EDGE_LANES)] = e
    first = next(_blocks(L, threads, points))
    on_domain = []
    for k, i in enumerate((0, points // 2, points - 1)):
        ta, tb = first[1][i], first[2][i]
        d["zetas"][k], d["gzetas"][k] = (d["xs"][ta], 0), (d["xs"][tb], 0)
        on_domain += [(k, ta), (k, tb)]
    assert len(set(d["xs"].tolist())) == L  # each planted zeta meets one point only
    want = gl.to_u64(fi.fri_initial_plain(*_t(d)))
    got = _replay(d, threads, warp, points)
    assert np.array_equal(got, want) and got.max() < P
    for k, t in on_domain:  # the other term of that point is still there
        assert want[k, t].any()
