"""Batched Merkle-tree commitments with caps (PyTorch).

The prover commits to polynomial evaluation matrices by Merkle-hashing every
LDE row (leaf = all column values at one domain point) and reducing to a
2^cap_height cap — the plonky2 ``MerkleTree``/``MerkleCap`` shape.

All hashing is the batched Poseidon sponge of ``ops/poseidon.py``: one
``hash_no_pad`` over [n, leaf_width] for leaves, then log2(n) - cap_height
rounds of batched two-to-one hashing.  The builders take K same-shape trees
at once ([K, n, leaf_width] leaves, ``*_batch``), every level of all K trees
in one call; the single-tree builders are those at K = 1.  On the card each
absorb step is one launch of the permutation kernel; ``fused_sponge=True`` routes leaves and
levels through the one-launch sponge kernel instead (see ``ops/poseidon.py``).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from . import goldilocks as gl
from . import poseidon as ps


def fetch_arrays(*arrs) -> list:
    """Device -> host transfer of several tensors as numpy uint64 arrays.

    On a CUDA device all tensors are raveled and concatenated on the card
    and read back with a single transfer, then split/reshaped on host."""
    if len(arrs) == 1 or not arrs[0].is_cuda:
        return [gl.to_u64(a) for a in arrs]
    flat_np = gl.to_u64(torch.cat([a.reshape(-1) for a in arrs]))
    out = []
    off = 0
    for a in arrs:
        size = a.numel()
        out.append(flat_np[off : off + size].reshape(tuple(a.shape)))
        off += size
    return out


@dataclass
class MerkleTree:
    """levels[0] = leaf digests [n, 4]; levels[-1] = cap [2^cap_height, 4].
    Kept as numpy uint64 for cheap host-side path extraction."""

    levels: list
    cap_height: int

    @property
    def cap(self) -> np.ndarray:
        return self.levels[-1]

    def prove(self, index: int) -> list:
        """Sibling digests from leaf level up to (excluding) the cap."""
        path = []
        for level in self.levels[:-1]:
            path.append(level[index ^ 1])
            index >>= 1
        return path


@dataclass
class DeviceMerkleTree:
    """Merkle tree whose levels stay device-resident; only the cap (which
    the Fiat-Shamir transcript needs on host) is fetched eagerly.

    A proof only ever touches ~num_query_rounds leaf rows and auth paths of
    a commitment tree, so query-time extraction gathers just the touched
    digests on the device (``path_gathers``) and rides one small combined
    fetch."""

    levels_dev: list  # tensors [m_i, 4], levels_dev[0] = leaf digests
    cap_height: int
    cap_np: np.ndarray = None

    @property
    def cap(self) -> np.ndarray:
        return self.cap_np

    @property
    def levels(self):  # duck-type the parts of MerkleTree that only
        return self.levels_dev  # need shapes (e.g. fri.query bookkeeping)

    def path_gathers(self, indices) -> list:
        """Device gathers of the sibling digests for each query index:
        returns a list over levels of [nq, 4] tensors (excluding the cap).
        Combine across trees with one ``fetch_arrays``."""
        # np.array (not asarray): >>= below mutates, callers reuse indices
        idx = np.array(indices, dtype=np.int64)
        out = []
        for level in self.levels_dev[:-1]:
            out.append(level[torch.from_numpy(idx ^ 1).to(level.device)])
            idx >>= 1
        return out

    def open_gathers(self, indices) -> list:
        """[leaf rows at ``indices``] + ``path_gathers``: the full query
        opening of this tree as device gathers."""
        idx = np.array(indices, dtype=np.int64)
        leaves = self.levels_dev[0]
        return [leaves[torch.from_numpy(idx).to(leaves.device)]] + self.path_gathers(indices)


def hash_leaves(leaf_data: torch.Tensor, fused_sponge: bool = False) -> torch.Tensor:
    """[..., n, leaf_width] -> [..., n, 4] digests.

    Matches plonky2's hash_or_noop: a leaf of width <= 4 is used directly
    (zero-padded), wider leaves are hash_no_pad'ed.  ``leaf_data`` may be a
    strided view (a transposed LDE): the chained route reads it through its
    strides; the fused route does too where the leading axes fold into the
    rows without a copy (one tree), and copies the leaves of several trees
    into one [K * n, leaf_width] matrix first.
    """
    width = leaf_data.shape[-1]
    if width <= 4:
        out = torch.zeros(leaf_data.shape[:-1] + (4,), dtype=torch.int64, device=leaf_data.device)
        out[..., :width] = leaf_data
        return out
    return ps.hash_no_pad(leaf_data, fused_sponge=fused_sponge)


def _level_two_to_one_batch(cur: torch.Tensor, fused_sponge: bool = False) -> torch.Tensor:
    """One level of K trees: [K, m, 4] digests -> [K, m/2, 4].  Siblings are
    adjacent rows, so the pair table is a free reshape [K, m, 4] -> [K, m/2,
    8], and the K trees' pairs go through one sponge call."""
    K, m, _ = cur.shape
    return ps.hash_no_pad(cur.reshape(K, m // 2, 8), fused_sponge=fused_sponge)


def build_merkle_levels_batch(leaf_data, cap_height: int, device=None,
                              fused_sponge: bool = False) -> list:
    """Device-resident levels of K same-shape trees: leaf rows [K, m, w] ->
    list of [K, m_i, 4] (levels[0] = leaf digests, levels[-1] = the K caps).
    Each level hashes all K trees' nodes in one call: the batch axis folds
    into the row axis, so K trees cost one tree's launches."""
    leaf_data = gl.as_field(leaf_data, device)
    K, m, _ = leaf_data.shape
    assert m & (m - 1) == 0, "leaf count must be a power of two"
    assert m >= 1 << cap_height
    levels_dev = [hash_leaves(leaf_data, fused_sponge)]
    while levels_dev[-1].shape[1] > 1 << cap_height:
        levels_dev.append(_level_two_to_one_batch(levels_dev[-1], fused_sponge))
    return levels_dev


def trees_from_batch_levels(levels_np: list, cap_height: int) -> list:
    """Host [K, m_i, 4] level arrays -> K ``MerkleTree``s (views of them)."""
    K = levels_np[0].shape[0]
    return [MerkleTree(levels=[lv[k] for lv in levels_np], cap_height=cap_height)
            for k in range(K)]


def build_merkle_trees_batch(leaf_data, cap_height: int, device=None,
                             fused_sponge: bool = False) -> list:
    """K independent same-shape trees of leaf rows [K, m, w] in one pass; all
    levels come back to host in one transfer.  Returns K ``MerkleTree``s."""
    levels_dev = build_merkle_levels_batch(leaf_data, cap_height, device, fused_sponge)
    return trees_from_batch_levels(fetch_arrays(*levels_dev), cap_height)


def device_merkle_trees_batch(leaf_data, cap_height: int, device=None,
                              fused_sponge: bool = False) -> list:
    """Like ``build_merkle_trees_batch`` but the levels stay on the device
    and only the K caps are fetched (one transfer).  Returns K
    ``DeviceMerkleTree``s whose levels are views of the batched levels."""
    levels_dev = build_merkle_levels_batch(leaf_data, cap_height, device, fused_sponge)
    caps_np = fetch_arrays(levels_dev[-1])[0]
    return [DeviceMerkleTree(levels_dev=[lv[k] for lv in levels_dev], cap_height=cap_height,
                             cap_np=caps_np[k])
            for k in range(caps_np.shape[0])]


def device_merkle_tree(leaf_data, cap_height: int, device=None, fused_sponge: bool = False) -> DeviceMerkleTree:
    """Like ``build_merkle_tree`` but fetches ONLY the cap."""
    leaf_data = gl.as_field(leaf_data, device)
    return device_merkle_trees_batch(leaf_data[None], cap_height, fused_sponge=fused_sponge)[0]


def build_merkle_tree(leaf_data, cap_height: int, device=None, fused_sponge: bool = False) -> MerkleTree:
    """leaf_data: [n, leaf_width] (n a power of two >= 2^cap_height).  All
    levels come back to host in one transfer (``fetch_arrays``)."""
    leaf_data = gl.as_field(leaf_data, device)
    return build_merkle_trees_batch(leaf_data[None], cap_height, fused_sponge=fused_sponge)[0]


def verify_merkle_proof(leaf_data, index: int, path: list, cap: np.ndarray) -> bool:
    """Scalar verification (host): fold leaf up the path, compare to cap."""
    leaf = [int(x) for x in leaf_data]
    if len(leaf) <= 4:
        digest = tuple((leaf + [0, 0, 0, 0])[:4])
    else:
        digest = tuple(ps.hash_no_pad_s(leaf))
    for sibling in path:
        sib = tuple(int(x) for x in sibling)
        if index & 1:
            digest = tuple(ps.two_to_one_s(sib, digest))
        else:
            digest = tuple(ps.two_to_one_s(digest, sib))
        index >>= 1
    return digest == tuple(int(x) for x in cap[index])
