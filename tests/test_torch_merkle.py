"""Port vs JAX package: Merkle trees with caps — every level, every path,
the width <= 4 pass-through, device-resident gathers and the host verifier."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from intmax_zkp_core_tpu.ops import merkle as jmk
from intmax_zkp_core_tpu_torch.ops import goldilocks as tgl
from intmax_zkp_core_tpu_torch.ops import merkle as tmk

torch.set_num_threads(1)

P = 0xFFFFFFFF00000001


def _leaves(seed, n, width):
    return np.random.default_rng(seed).integers(0, P, size=(n, width), dtype=np.uint64)


@pytest.mark.parametrize("n,width,cap_height", [(64, 9, 2), (32, 135, 0), (16, 4, 1), (16, 3, 4)])
def test_every_level_and_path_matches(n, width, cap_height):
    leaves = _leaves(n + width, n, width)
    jt = jmk.build_merkle_tree(jnp.asarray(leaves), cap_height)
    tt = tmk.build_merkle_tree(leaves, cap_height, device="cpu")
    assert len(jt.levels) == len(tt.levels)
    for a, b in zip(jt.levels, tt.levels):
        assert (np.asarray(a) == b).all()
    if width <= 4:  # pass-through: the leaf level IS the zero-padded data
        assert (tt.levels[0][:, :width] == leaves).all()
        assert (tt.levels[0][:, width:] == 0).all()
    for idx in range(n):
        jp = [tuple(int(x) for x in d) for d in jt.prove(idx)]
        tp = [tuple(int(x) for x in d) for d in tt.prove(idx)]
        assert jp == tp
    for idx in (0, 1, n // 2, n - 1):
        assert tmk.verify_merkle_proof(leaves[idx], idx, tt.prove(idx), tt.cap)
        assert not tmk.verify_merkle_proof(leaves[idx ^ 1], idx, tt.prove(idx), tt.cap)


@pytest.mark.parametrize("width", [20, 135])
@pytest.mark.parametrize("mode", [{}, {"fused_sponge": True}])
def test_device_tree_gathers_and_transposed_leaves(mode, width):
    n, cap_height = 64, 3
    leaves = _leaves(5, n, width)
    host = tmk.build_merkle_tree(leaves, cap_height, device="cpu")
    # leaves handed over as the transposed view of a [width, n] matrix
    cols = tgl.from_u64(np.ascontiguousarray(leaves.T), "cpu")
    dev = tmk.device_merkle_tree(cols.t(), cap_height, **mode)
    assert (dev.cap == host.cap).all()
    idx = [0, 5, 5, 63, 32]
    opened = tmk.fetch_arrays(*dev.open_gathers(idx))
    assert (opened[0] == host.levels[0][idx]).all()
    for k, i in enumerate(idx):
        path = [tuple(int(x) for x in level[k]) for level in opened[1:]]
        assert path == [tuple(int(x) for x in d) for d in host.prove(i)]
