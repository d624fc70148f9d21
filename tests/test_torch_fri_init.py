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
