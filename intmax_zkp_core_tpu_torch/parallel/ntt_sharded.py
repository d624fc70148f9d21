"""The NTT over a mesh of devices: the four-step (Bailey) algorithm with two
exchanges, the counterpart of the JAX package's ``parallel/ntt_sharded.py``.

Decompose i = i1*n2 + i2 (matrix [n1, n2], row-major), k = k2*n1 + k1:

  A[k1, i2] = sum_{i1} x[i1, i2] * (w^{n2})^{i1 k1}   column NTTs (size n1)
  B[k1, i2] = A[k1, i2] * w^{i2 k1}                    twiddle
  X[k2*n1 + k1] = sum_{i2} B[k1, i2] * (w^{n1})^{i2 k2}  row NTTs (size n2)

Shard i holds the columns i2 in [i*n2/d, (i+1)*n2/d), so its column NTTs are
local; the first exchange hands shard j the rows k1 in [j*n1/d, (j+1)*n1/d)
of every column for its row NTTs, and the second hands shard m the outputs
k2 in [m*n2/d, (m+1)*n2/d), which are the m-th contiguous block of the
result in natural order.  An exchange (``parallel/mesh.py::exchange``) is a
copy of each block to the device that takes it between a process's own
shards (a peer copy between cards, a plain device copy between two shards
on one card) and one ``torch.distributed`` all-to-all across processes: a
process computes only its own shards.

Each shard's column and row NTTs go through ``ops/ntt.py::ntt``: on the card
the NTT kernel (``ops/ntt_cuda.py``), one launch each for every n up to 2^22
(n1 and n2 at most 2^11); on the CPU its plain version.  The
twiddle is the single-device four-step's table (``ntt_cuda.fourstep_twiddles``)
sliced to the shard's columns.  The result equals ``ops/ntt.py::ntt`` bit for
bit.
"""

from __future__ import annotations

import torch

from ..ops import goldilocks as gl
from ..ops import ntt as nt
from ..ops.ntt_cuda import fourstep_twiddles
from .mesh import Mesh, exchange, local_devices

P = gl.P_INT


def _twiddle_matrix(log_n1: int, log_n2: int, device="cpu") -> torch.Tensor:
    """w^{i2*k1} at [k1, i2] as an [n1, n2] table on ``device``."""
    return fourstep_twiddles(log_n1, log_n2, False, torch.device(device))


def can_shard(n: int, d: int) -> bool:
    """True if a length-n NTT four-step-decomposes with both factors
    divisible by the shard count (n1 = 2^(log n // 2))."""
    if n & (n - 1) or n <= 0:
        return False
    log_n = n.bit_length() - 1
    n1 = 1 << (log_n // 2)
    n2 = n // n1
    return n1 % d == 0 and n2 % d == 0


def ntt_sharded_batch(x: torch.Tensor, mesh: Mesh) -> tuple:
    """Batched four-step NTT over the mesh: coefficient rows [B, n] ->
    evaluations in natural order as this process's parts [B, n/d], part m
    (outputs [m*n/d, (m+1)*n/d), m counted over the whole mesh from
    ``mesh.first``) on its device of ``mesh.devices``.  Every process passes
    the same ``x``.  Raises unless n is a power of two whose four-step
    factors d divides (``can_shard``)."""
    devices = local_devices(mesh)
    d, first = mesh.size, mesh.first
    B, n = x.shape
    log_n = n.bit_length() - 1
    if n != 1 << log_n or not can_shard(n, d):
        raise ValueError(f"a length-{n} NTT does not split over {d} shards")
    log_n1 = log_n // 2
    n1, n2 = 1 << log_n1, n >> log_n1
    w, h = n2 // d, n1 // d  # columns per shard, rows per shard
    cols = x.reshape(B, n1, n2)
    # column NTTs of each shard's columns, then the twiddle w^(i2 * k1):
    # b[i] [B, w, n1], its columns as rows
    b = []
    for i, dev in enumerate(devices):
        g = first + i
        part = cols[:, :, g * w : (g + 1) * w].transpose(1, 2).contiguous().to(dev)
        tw = _twiddle_matrix(log_n1, log_n - log_n1, dev)[:, g * w : (g + 1) * w]
        b.append(gl.mul(nt.ntt(part), tw.t().contiguous()))
    # first exchange: shard j takes the rows k1 of its block from every
    # column, then its row NTTs: c[j] [B, h, n2]
    got = exchange([[bi[:, :, j * h : (j + 1) * h] for j in range(d)] for bi in b], mesh)
    del b
    c = [nt.ntt(torch.cat(blocks, dim=1).transpose(1, 2).contiguous()) for blocks in got]
    # second exchange: shard m takes the outputs k2 of its block from every
    # row block, in natural order k = k2 * n1 + k1
    got = exchange([[cj[:, :, m * w : (m + 1) * w] for m in range(d)] for cj in c], mesh)
    del c
    return tuple(torch.cat(blocks, dim=1).transpose(1, 2).reshape(B, w * n1) for blocks in got)


def ntt_sharded(x: torch.Tensor, mesh: Mesh) -> tuple:
    """Single-polynomial NTT [n] over the mesh: this process's parts [n/d]
    of the evaluations in natural order."""
    return tuple(p[0] for p in ntt_sharded_batch(x[None], mesh))


def coset_lde_sharded(
    a: torch.Tensor,
    rate_bits: int,
    mesh: Mesh,
    shift: int = gl.MULTIPLICATIVE_GROUP_GENERATOR,
) -> tuple:
    """Sharded counterpart of ``ops/ntt.py::coset_lde``: coefficient rows
    [B, n] -> their evaluations on the shifted 2^rate_bits-times larger coset
    as this process's parts [B, lde_n/d] (``ntt_sharded_batch``)."""
    B, n = a.shape
    lde_n = n << rate_bits
    shifted = gl.mul(a, nt._shift_powers(n, shift % P, a.device))
    padded = torch.zeros((B, lde_n), dtype=torch.int64, device=a.device)
    padded[:, :n] = shifted
    return ntt_sharded_batch(padded, mesh)
