"""Merkle trees built over a mesh of devices: the counterpart of the JAX
package's ``parallel/merkle_sharded.py``.

The leaves arrive in d contiguous blocks, one per shard (the sharded LDE's
natural output).  Each shard hashes its block with ``ops/merkle.py::
hash_leaves`` (on the card the chained permutation kernel, or the one-launch
sponge kernel under ``fused_sponge=True``) and folds its subtree down to the
lowest level that still has a node per shard or per cap entry.  Pairs are the
even/odd rows of ``ops/merkle.py``; since the blocks are contiguous powers of
two, no pair crosses a shard.  Where the cap is smaller than d, only the d
block roots move: to the process's first device, from every process
(``parallel/mesh.py::gather``, the JAX package's ``all_gather`` of the
roots), and the top levels fold there, on every process.  A process hashes
only its own shards' blocks.  Every level equals
``ops/merkle.py::build_merkle_levels_batch``'s bit for bit.
"""

from __future__ import annotations

import torch

from ..ops import merkle as mk
from .mesh import Mesh, gather, local_devices

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


def n_top_levels(d: int, cap_height: int) -> int:
    """The levels above the d block roots that fold whole on every process
    (none where the cap has at least d nodes)."""
    cap_n = 1 << cap_height
    return 0 if cap_n >= d else (d // cap_n).bit_length() - 1


def build_merkle_levels_sharded(leaves, cap_height: int, mesh: Mesh,
                                fused_sponge: bool = False) -> list:
    """Leaf rows [..., n, w] -> the tree levels of each leading index, like
    ``ops/merkle.py::build_merkle_levels_batch``, with the hashing and the
    folds sharded over ``mesh``.

    ``leaves`` is one tensor, the same on every process, split here into d
    row blocks, or this process's blocks [..., n/d, w] (part i, block
    ``mesh.first + i``, on ``mesh.devices[i]``).  Returns one entry per
    level, leaf digests first: a level of at least max(d, 2^cap_height)
    nodes is this process's parts [..., m/d, 4]; each of the
    ``n_top_levels`` smaller ones is one part, the whole level, on
    ``mesh.devices[0]`` (``gather_levels`` assembles them)."""
    global SHARDED_TREE_CALLS
    devices = local_devices(mesh)
    d, L = mesh.size, len(devices)
    if isinstance(leaves, torch.Tensor):
        n = leaves.shape[-2]
        if n % d:
            raise ValueError(f"{n} leaves do not split over {d} shards")
        mine = leaves.split(n // d, dim=-2)[mesh.first : mesh.first + L]
        parts = [p.to(dev) for p, dev in zip(mine, devices)]
    else:
        parts = list(leaves)
        if len(parts) != L:
            raise ValueError(f"{len(parts)} leaf blocks for a process of {L} shards")
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
        # only the d block roots move; the top levels fold on every process
        cur = gather([levels[-1] for levels in shard_levels], 1, devices[0], mesh)
        while cur.shape[1] > cap_n:
            cur = mk._level_two_to_one_batch(cur, fused_sponge)
            out.append((cur.reshape(lead + cur.shape[1:]),))
    SHARDED_TREE_CALLS += 1
    return out


def gather_levels(levels: list, cap_height: int, mesh: Mesh, device) -> list:
    """``build_merkle_levels_sharded``'s levels, each whole on ``device``
    (on every process, for a mesh over several)."""
    top = len(levels) - n_top_levels(mesh.size, cap_height)
    return [gather(parts, -2, device, mesh) if k < top else parts[0].to(device)
            for k, parts in enumerate(levels)]
