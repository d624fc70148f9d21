"""A distributed proving step over a mesh, the counterpart of the JAX
package's ``parallel/prove_step.py``: the three parallel axes in one call.

* batch: each shard permutes its block of Poseidon states (on the card one
  launch of the permutation kernel per shard);
* tree: each shard folds the digests of its states into a local root, and
  the d roots, gathered onto the first device (from every process, for a
  mesh over several), fold into the global root;
* intra-op: one NTT of the polynomial, four-step over the mesh
  (``parallel/ntt_sharded.py``).
"""

from __future__ import annotations

import torch

from ..ops import poseidon as ps
from ..ops.poseidon_cuda import permute_cuda
from .mesh import Mesh, gather, local_devices
from .ntt_sharded import ntt_sharded


def _local_merkle_root(digests: torch.Tensor) -> torch.Tensor:
    """[L, 4] -> [4] by repeated two_to_one (L a power of two)."""
    while digests.shape[0] > 1:
        digests = ps.two_to_one(digests[0::2], digests[1::2])
    return digests[0]


def make_distributed_prove_step(mesh: Mesh):
    """A function (states [B, 12], poly [n]) -> (hashed, evals, root): the
    permuted states as this process's parts [B/d, 12], the NTT of ``poly``
    as its parts [n/d] in natural order (part i is shard ``mesh.first + i``),
    and the Merkle root [4] (on the first device, on every process) of the
    permuted states' first four lanes, each shard's block a subtree.  B/d
    must be a power of two; every process passes the same inputs."""
    devices = local_devices(mesh)
    d, first = mesh.size, mesh.first

    def step(states: torch.Tensor, poly: torch.Tensor):
        B = states.shape[0]
        if B % d or (B // d) & (B // d - 1):
            raise ValueError(f"{B} states do not split into {d} power-of-two blocks")
        blocks = states.split(B // d)
        hashed, roots = [], []
        for i, dev in enumerate(devices):
            h = permute_cuda(blocks[first + i].to(dev).contiguous())
            hashed.append(h)
            roots.append(_local_merkle_root(h[:, :4])[None])
        root = _local_merkle_root(gather(roots, 0, devices[0], mesh))
        return tuple(hashed), ntt_sharded(poly, mesh), root

    return step
