"""A distributed proving step over a mesh, the counterpart of the JAX
package's ``parallel/prove_step.py``: the three parallel axes in one call.

* batch: each shard permutes its block of Poseidon states (on the card one
  launch of the permutation kernel per shard);
* tree: each shard folds the digests of its states into a local root, and
  the d roots, moved to the first device, fold into the global root;
* intra-op: one NTT of the polynomial, four-step over the mesh
  (``parallel/ntt_sharded.py``).
"""

from __future__ import annotations

import torch

from ..ops import poseidon as ps
from ..ops.poseidon_cuda import permute_cuda
from .mesh import Mesh, local_devices
from .ntt_sharded import ntt_sharded


def _local_merkle_root(digests: torch.Tensor) -> torch.Tensor:
    """[L, 4] -> [4] by repeated two_to_one (L a power of two)."""
    while digests.shape[0] > 1:
        digests = ps.two_to_one(digests[0::2], digests[1::2])
    return digests[0]


def make_distributed_prove_step(mesh: Mesh):
    """A function (states [B, 12], poly [n]) -> (hashed, evals, root): the
    permuted states as d parts [B/d, 12], the NTT of ``poly`` as d parts
    [n/d] in natural order, and the Merkle root [4] (on the first device) of
    the permuted states' first four lanes, each shard's block a subtree.
    B/d must be a power of two."""
    devices = local_devices(mesh)
    d = len(devices)

    def step(states: torch.Tensor, poly: torch.Tensor):
        B = states.shape[0]
        if B % d or (B // d) & (B // d - 1):
            raise ValueError(f"{B} states do not split into {d} power-of-two blocks")
        hashed, roots = [], []
        for part, dev in zip(states.split(B // d), devices):
            h = permute_cuda(part.to(dev).contiguous())
            hashed.append(h)
            roots.append(_local_merkle_root(h[:, :4]).to(devices[0]))
        root = _local_merkle_root(torch.stack(roots))
        return tuple(hashed), ntt_sharded(poly, mesh), root

    return step
