"""Merkle trees built over a mesh of devices: the counterpart of the JAX
package's ``parallel/merkle_sharded.py``.

The leaves arrive in d contiguous blocks, one per shard (the sharded LDE's
natural output).  Each shard hashes its block with ``ops/merkle.py::
hash_leaves`` (on the card the chained permutation kernel, or the one-launch
sponge kernel under ``fused_sponge=True``) and folds its subtree down to the
lowest level that still has a node per shard or per cap entry.  Pairs are the
even/odd rows of ``ops/merkle.py``; since the blocks are contiguous powers of
two, no pair crosses a shard.  Where the cap is smaller than d, only the d
block roots move, to the first device, and the top levels fold there.  Every
level equals ``ops/merkle.py::build_merkle_levels_batch``'s bit for bit.
"""

from __future__ import annotations

import torch

from ..ops import merkle as mk
from .mesh import Mesh, local_devices

# bumped on every sharded tree build (tests read it to see the path taken)
SHARDED_TREE_CALLS = 0


def can_shard_tree(n: int, d: int, cap_height: int) -> bool:
    """True if n leaves split into d contiguous power-of-two blocks that
    cover the cap level (cap nodes must not be finer than one per leaf)."""
    if n <= 0 or n & (n - 1) or d <= 1:
        return False
    if n % d or (n // d) & (n // d - 1):
        return False
    return n >= (1 << cap_height) and n > d


def build_merkle_levels_sharded(leaves, cap_height: int, mesh: Mesh,
                                fused_sponge: bool = False) -> list:
    """Leaf rows [..., n, w] -> the tree levels of each leading index, like
    ``ops/merkle.py::build_merkle_levels_batch``, with the hashing and the
    folds sharded over ``mesh``.

    ``leaves`` is one tensor, split here into d row blocks, or already its
    d blocks [..., n/d, w] (part i on ``mesh.devices[i]``).  Returns one
    entry per level, leaf digests first: a level of at least max(d,
    2^cap_height) nodes is its d parts [..., m/d, 4]; a smaller top level is
    one part on ``mesh.devices[0]`` (``parallel/mesh.py::gather(parts, -2,
    device)`` assembles either)."""
    global SHARDED_TREE_CALLS
    devices = local_devices(mesh)
    d = len(devices)
    if isinstance(leaves, torch.Tensor):
        n = leaves.shape[-2]
        if n % d:
            raise ValueError(f"{n} leaves do not split over {d} shards")
        parts = [p.to(dev) for p, dev in zip(leaves.split(n // d, dim=-2), devices)]
    else:
        parts = list(leaves)
        if len(parts) != d:
            raise ValueError(f"{len(parts)} leaf blocks for a mesh of {d} shards")
        n = parts[0].shape[-2] * d
    if not can_shard_tree(n, d, cap_height):
        raise ValueError(f"a tree of {n} leaves at cap height {cap_height} does not split "
                         f"over {d} shards")
    lead = parts[0].shape[:-2]
    cap_n = 1 << cap_height
    lowest_sharded = max(d, cap_n)
    # each shard: its leaf digests and its subtree's folds, as [Kf, m, 4]
    shard_levels = []
    for part in parts:
        digs = mk.hash_leaves(part, fused_sponge)
        levels = [digs.reshape((-1,) + digs.shape[-2:])]
        while levels[-1].shape[1] * d > lowest_sharded:
            levels.append(mk._level_two_to_one_batch(levels[-1], fused_sponge))
        shard_levels.append(levels)
    out = [tuple(lv.reshape(lead + lv.shape[1:]) for lv in level)
           for level in zip(*shard_levels)]
    if cap_n < d:
        # only the d block roots move; the top levels fold on one device
        cur = torch.cat([levels[-1].to(devices[0]) for levels in shard_levels], dim=1)
        while cur.shape[1] > cap_n:
            cur = mk._level_two_to_one_batch(cur, fused_sponge)
            out.append((cur.reshape(lead + cur.shape[1:]),))
    SHARDED_TREE_CALLS += 1
    return out
