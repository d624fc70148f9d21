"""K3, the permutation-argument columns: the port's plain version against the
JAX package's eager limb twin of its Pallas kernel, bit for bit.

Same inputs from a numpy seed through ``perm_columns_jnp_limb`` (the tile
computation of the Pallas kernel run eagerly, as the JAX package's own CPU
test runs it) and through ``perm_columns_plain`` / ``perm_columns_cuda`` of
the port (on the CPU the wrapper takes the plain version).  Tolerance 0."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from intmax_zkp_core_tpu.ops.perm_columns_pallas import perm_columns_jnp_limb
from intmax_zkp_core_tpu_torch.ops import goldilocks as gl
from intmax_zkp_core_tpu_torch.ops import perm_columns_cuda as pcol

torch.set_num_threads(1)

P = gl.P_INT
N, C = 64, 2


def _inputs(R, K=1, seed=41):
    rng = np.random.default_rng(seed + R)
    wires = rng.integers(0, P, size=(K, R, N), dtype=np.uint64)
    wires.reshape(-1)[::7] = 0  # lanes of 0 and p-1
    wires.reshape(-1)[3::11] = P - 1
    id_vals = rng.integers(0, P, size=(R, N), dtype=np.uint64)
    sigma = rng.integers(0, P, size=(R, N), dtype=np.uint64)
    betas = rng.integers(1, P, size=(K, C), dtype=np.uint64)
    gammas = rng.integers(1, P, size=(K, C), dtype=np.uint64)
    return wires, betas, gammas, id_vals, sigma


def _t(*arrays):
    return [gl.from_u64(a, "cpu") for a in arrays]


@pytest.mark.parametrize("R", [3, 7, 16, 23])
def test_perm_columns_plain_equals_jax(R):
    wires, betas, gammas, id_vals, sigma = _inputs(R)
    jz, jpp, jwrap = perm_columns_jnp_limb(
        jnp.asarray(wires[0]), jnp.asarray(betas[0]), jnp.asarray(gammas[0]),
        jnp.asarray(id_vals), jnp.asarray(sigma),
    )
    z, pp, wrap = pcol.perm_columns_plain(*_t(wires, betas, gammas, id_vals, sigma))
    nch = (R + 6) // 7
    assert z.shape == (1, C, N) and pp.shape == (1, C, nch - 1, N) and wrap.shape == (1, C)
    assert np.array_equal(gl.to_u64(z[0]), np.asarray(jz))
    assert np.array_equal(gl.to_u64(pp[0]), np.asarray(jpp))
    assert np.array_equal(gl.to_u64(wrap[0]), np.asarray(jwrap))


@pytest.mark.parametrize("R", [3, 7, 16, 23])
def test_wrapper_on_cpu_takes_the_plain_version_and_batches(R):
    # K = 2 in one call against two single calls; extra wire rows are ignored
    wires, betas, gammas, id_vals, sigma = _inputs(R, K=2)
    wide = np.concatenate([wires, np.full((2, 2, N), 5, dtype=np.uint64)], axis=1)
    tw, tb, tg, ti, ts = _t(wide, betas, gammas, id_vals, sigma)
    before = pcol.cb.launch_counts()
    z, pp, wrap = pcol.perm_columns_cuda(tw, tb, tg, ti, ts)
    assert pcol.cb.launch_counts() == before  # a CPU tensor launches nothing
    for k in range(2):
        zk, ppk, wrapk = pcol.perm_columns_plain(
            *_t(wires[k : k + 1], betas[k : k + 1], gammas[k : k + 1], id_vals, sigma)
        )
        assert torch.equal(z[k], zk[0]) and torch.equal(pp[k], ppk[0])
        assert torch.equal(wrap[k], wrapk[0])


@pytest.mark.parametrize("R", [7, 23])
def test_stage1_outputs_are_what_they_are_called(R):
    # f_pref / g_pref_inv / row_quot against exact Python ints on a few points
    wires, betas, gammas, id_vals, sigma = _inputs(R)
    f_pref, g_pref_inv, row_quot = (
        gl.to_u64(t) for t in pcol.stage1_plain(*_t(wires, betas, gammas, id_vals, sigma))
    )
    nch = (R + 6) // 7
    for c in range(C):
        beta, gamma = int(betas[0, c]), int(gammas[0, c])
        for x in (0, 1, N - 1):
            f = g = 1
            for j in range(nch):
                for i in range(7 * j, min(7 * j + 7, R)):
                    w = int(wires[0, i, x])
                    f = f * ((w + beta * int(id_vals[i, x]) + gamma) % P) % P
                    g = g * ((w + beta * int(sigma[i, x]) + gamma) % P) % P
                assert int(f_pref[0, c, j, x]) == f
                if j < nch - 1:
                    assert int(g_pref_inv[0, c, j, x]) == pow(g, P - 2, P)
            assert int(row_quot[0, c, x]) == f * pow(g, P - 2, P) % P


def test_wrapper_refuses_what_the_kernel_cannot_take():
    wires, betas, gammas, id_vals, sigma = _t(*_inputs(7))
    with pytest.raises(TypeError):
        pcol.perm_columns_cuda(wires.to(torch.int32), betas, gammas, id_vals, sigma)
    with pytest.raises(ValueError):
        pcol.perm_columns_cuda(wires[:, :5], betas, gammas, id_vals, sigma)  # fewer rows than R
    with pytest.raises(ValueError):
        pcol.perm_columns_cuda(wires, betas, gammas, id_vals, sigma[:, :8])
