"""Hand-written CUDA kernels for Poseidon-12 and their PyTorch wrappers.

Two kernels, both in ``csrc/poseidon.cu`` over ``csrc/goldilocks.cuh``:

* ``permute_cuda(states)``  [..., 12] -> [..., 12].  Replaces the JAX
  package's ``ops/poseidon_pallas.py::permute_pallas``.
* ``hash_no_pad_cuda(inputs)``  [B, width >= 1] -> [B, 4], the whole rate-8
  overwrite-absorb sponge in one launch.  Replaces
  ``ops/poseidon_pallas.py::hash_no_pad_pallas``.  It takes the strides of
  its input, so a transposed ``[width, B]`` matrix (an LDE handed over as
  ``lde.t()``) is hashed without materializing the transpose, and
  neighbouring threads read neighbouring addresses.

Design: one thread per permutation, state in 64-bit registers, grid-stride
loop; any batch size >= 1.  The state is loose between rounds (any u64
standing for its residue mod p) and made canonical once per output lane;
the next round's constants are folded into each full round's MDS reduction;
the 22 partial rounds run in the sparse form of ``ops/poseidon_fast.py``.
The tables sit in ``__constant__`` memory, uploaded once per device from
``kernel_tables`` (built from the Python constants in the order the kernel
reads them).  The sponge stages the next rate-8 chunk of its rows in shared
memory while the current permutation runs.

What bounds them on the card: a permutation moves 192 bytes but needs about
6.4 thousand 32-bit integer multiply-adds (the sparse form; 6,480 as the
kernel computes them), so the integer pipe — not memory — is the limit.
``chip_smoke.py`` prints measured times beside that bound.

The plain PyTorch versions are ``permute`` and ``hash_no_pad`` of
``ops/poseidon.py`` (re-exported below as ``permute_plain`` /
``hash_no_pad_plain``).  A wrapper takes the plain version only for a tensor
that lies on the CPU; for a CUDA tensor it launches its kernel or raises.

Build and loading: ``ops/cuda_build.py`` (``nvcc`` for ``sm_90a`` into a shared
library with a plain C interface under ``_build/`` at first use, loaded with
``ctypes``; a build failure is an exception).  Its names are re-exported here.
"""

from __future__ import annotations

import ctypes

import torch

from . import cuda_build as cb
from .cuda_build import (  # noqa: F401  (this module's public names since the first kernels)
    BUILD_DIR,
    CSRC_DIR,
    LAUNCHES,
    LIBRARY,
    NVCC_FLAGS,
    build,
    find_nvcc,
    launch_counts,
    load,
    reset_launch_counts,
)
from .poseidon import hash_n_to_m_no_pad as _hash_n_to_m_no_pad
from .poseidon import permute as permute_plain
from .poseidon_constants import (
    ALL_ROUND_CONSTANTS,
    HALF_N_FULL_ROUNDS,
    MDS_MATRIX_CIRC,
    MDS_MATRIX_DIAG,
    N_PARTIAL_ROUNDS,
    SPONGE_WIDTH,
)
from .poseidon_fast import (
    FAST_PARTIAL_FIRST_RC,
    FAST_PARTIAL_RC,
    INIT_MATRIX,
    M00,
    SPARSE_ROUNDS,
)

_constants_on: set = set()  # device indices whose __constant__ tables are filled


def hash_no_pad_plain(inputs: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of ``hash_no_pad_cuda`` (chained plain
    permutations), on whatever device ``inputs`` lies."""
    return _hash_n_to_m_no_pad(inputs, 4, permutation=permute_plain)


def kernel_tables() -> dict:
    """The constant tables of ``csrc/poseidon.cu``, flat, in the order the
    kernel reads them:

    * ``full_rc`` [2, 5, 12]: for each half of the full rounds, the constants
      added to the state on entry, then the constants folded into the MDS
      reduction of each of its four rounds — the next round's, except after
      the last round of a half: ``FAST_PARTIAL_FIRST_RC`` before the partial
      rounds, nothing (zeros) before the output;
    * ``init`` [11, 11]: ``INIT_MATRIX`` on lanes 1..11 (it is the identity
      on lane 0);
    * ``sparse`` [22, 24]: for partial round i, ``FAST_PARTIAL_RC[i]``,
      ``M00``, ``w_hat`` (11) and ``v`` (11) of ``SPARSE_ROUNDS[i]``.
    """
    T, h = SPONGE_WIDTH, HALF_N_FULL_ROUNDS
    rc = [ALL_ROUND_CONSTANTS[r * T : (r + 1) * T] for r in range(2 * h + N_PARTIAL_ROUNDS)]
    first, second = rc[:h], rc[h + N_PARTIAL_ROUNDS :]
    full = first + [list(FAST_PARTIAL_FIRST_RC)] + second + [[0] * T]
    assert INIT_MATRIX[0] == [1] + [0] * (T - 1)
    assert all(row[0] == 0 for row in INIT_MATRIX[1:])
    sparse = []
    for i, (w_hat, v) in enumerate(SPARSE_ROUNDS):
        sparse += [FAST_PARTIAL_RC[i], M00, *w_hat, *v]
    return {
        "full_rc": [c for row in full for c in row],
        "init": [c for row in INIT_MATRIX[1:] for c in row[1:]],
        "sparse": sparse,
    }


def set_constants(lib) -> int:
    """Fill the ``__constant__`` tables of ``lib``'s Poseidon kernels on the
    current device: the 12 circulant MDS entries (the shared header's table)
    and the one diagonal entry, then ``kernel_tables``' full_rc, init and
    sparse.  Returns the code of ``poseidon_set_constants``."""
    assert not any(MDS_MATRIX_DIAG[1:]), "kernel assumes a single diagonal entry"
    tables = kernel_tables()
    circ, full_rc, init, sparse = [
        (ctypes.c_ulonglong * len(v))(*v)
        for v in (MDS_MATRIX_CIRC, tables["full_rc"], tables["init"], tables["sparse"])]
    return lib.poseidon_set_constants(circ, MDS_MATRIX_DIAG[0], full_rc, init, sparse)


def _ready(device: torch.device) -> None:
    """Library loaded and its ``__constant__`` tables filled on ``device``."""
    lib = load()
    index = device.index if device.index is not None else torch.cuda.current_device()
    if index not in _constants_on:
        with torch.cuda.device(index):
            code = set_constants(lib)
        cb.check(code, "poseidon_set_constants")
        _constants_on.add(index)


def permute_cuda(states: torch.Tensor) -> torch.Tensor:
    """Poseidon permutation of [..., 12] int64 bit patterns.

    CUDA tensor: one launch of the hand-written kernel (or an exception).
    CPU tensor: the plain PyTorch version."""
    if states.dtype != torch.int64:
        raise TypeError(f"permute_cuda wants int64 bit patterns, got {states.dtype}")
    if states.dim() < 1 or states.shape[-1] != SPONGE_WIDTH:
        raise ValueError(f"permute_cuda wants [..., {SPONGE_WIDTH}], got {tuple(states.shape)}")
    if not states.is_cuda:
        return permute_plain(states)
    if not states.is_contiguous():
        raise ValueError("permute_cuda wants a contiguous tensor")
    out = torch.empty_like(states)
    rows = states.numel() // SPONGE_WIDTH
    if rows == 0:
        return out
    _ready(states.device)
    cb.launch("permute_cuda", "poseidon_permute", states.device,
              states.data_ptr(), out.data_ptr(), rows)
    return out


def hash_no_pad_cuda(inputs: torch.Tensor) -> torch.Tensor:
    """Fused sponge: [B, width >= 1] int64 bit patterns -> [B, 4] digests.

    Any strides are accepted (the kernel indexes with them).  CUDA tensor:
    one launch (or an exception).  CPU tensor: the plain version."""
    if inputs.dtype != torch.int64:
        raise TypeError(f"hash_no_pad_cuda wants int64 bit patterns, got {inputs.dtype}")
    if inputs.dim() != 2 or inputs.shape[1] < 1:
        raise ValueError(f"hash_no_pad_cuda wants [B, width >= 1], got {tuple(inputs.shape)}")
    if not inputs.is_cuda:
        return hash_no_pad_plain(inputs)
    rows, width = inputs.shape
    out = torch.empty((rows, 4), dtype=torch.int64, device=inputs.device)
    if rows == 0:
        return out
    _ready(inputs.device)
    cb.launch("hash_no_pad_cuda", "poseidon_hash_no_pad", inputs.device,
              inputs.data_ptr(), inputs.stride(0), inputs.stride(1), width,
              out.data_ptr(), rows)
    return out
