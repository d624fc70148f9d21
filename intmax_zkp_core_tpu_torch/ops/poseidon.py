"""Batched Poseidon-12 permutation and sponge hashing (PyTorch).

The permutation is the hot primitive of the whole framework: every Merkle
node hash, Merkle cap, transcript challenge and in-circuit Poseidon gate
boils down to it.

This module holds the *plain PyTorch versions* (``permute`` and the sponge
functions built on it) and the exact Python-int ``*_s`` functions.  The
hand-written CUDA kernels live in ``ops/poseidon_cuda.py``.  Routing:

* a tensor on the CPU always takes the plain version;
* a tensor on a CUDA device goes through ``poseidon_cuda.permute_cuda``, one
  kernel launch per absorb step (the chained sponge), or — with
  ``fused_sponge=True`` — through ``poseidon_cuda.hash_no_pad_cuda``, one
  launch for the whole sponge.

No switch sends a tensor on the card to the plain version: ``permute`` is
called directly where a kernel is held against it.

Sponge semantics: rate 8, capacity 4, zero-initialized state, overwrite
absorption, no padding for ``hash_no_pad``; ``hash_pad`` appends 1, zero-fills
to 11 mod 12, appends 1.

State layout is ``[..., 12]`` int64 bit patterns of canonical u64 values
(see ``ops/goldilocks.py``).
"""

from __future__ import annotations

import operator

import torch

from ..native.loader import native_hash_no_pad, native_permute_batch
from . import goldilocks as gl
from .poseidon_constants import (
    ALL_ROUND_CONSTANTS,
    HALF_N_FULL_ROUNDS,
    MDS_MATRIX_CIRC,
    MDS_MATRIX_DIAG,
    N_PARTIAL_ROUNDS,
    N_ROUNDS,
    SPONGE_RATE,
    SPONGE_WIDTH,
)

# MDS as a dense 12x12 small-int matrix: M[r][c] = CIRC[(c-r) % 12] + diag.
_MDS_INT = [
    [
        MDS_MATRIX_CIRC[(c - r) % SPONGE_WIDTH] + (MDS_MATRIX_DIAG[r] if r == c else 0)
        for c in range(SPONGE_WIDTH)
    ]
    for r in range(SPONGE_WIDTH)
]

_RC_CACHE: dict = {}


def _round_constants(device: torch.device) -> torch.Tensor:
    """[30, 12] round constants on ``device`` (uploaded once per device)."""
    rc = _RC_CACHE.get(device)
    if rc is None:
        rc = torch.tensor(
            [gl.i64(c) for c in ALL_ROUND_CONSTANTS], dtype=torch.int64
        ).reshape(N_ROUNDS, SPONGE_WIDTH).to(device)
        _RC_CACHE[device] = rc
    return rc


def _sbox(x):
    x2 = gl.square(x)
    x3 = gl.mul(x2, x)
    x6 = gl.square(x3)
    return gl.mul(x6, x)


_MDS_CACHE: dict = {}


def _mds_matrix_t(device: torch.device) -> torch.Tensor:
    """M^T as float64 on ``device`` (uploaded once per device)."""
    m = _MDS_CACHE.get(device)
    if m is None:
        m = torch.tensor(_MDS_INT, dtype=torch.float64).t().contiguous().to(device)
        _MDS_CACHE[device] = m
    return m


def _mds_layer(state: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """M @ state along ``dim`` (size 12), via 32-bit limb accumulation.

    The two limb sums acc[r] = sum_c M[r][c] * limb[c] are one small matrix
    product each, taken in float64: the coefficients are <= 49 and sum to
    at most 264 along a row, and the limbs are < 2^32, so every partial sum
    is an integer below 2^41 < 2^53 and the product is exact in any
    summation order.  The value acc_lo + acc_hi * 2^32 is then
    acc_lo + (acc_hi >> 32) * 2^64 + (acc_hi mod 2^32) * 2^32, and
    2^64 = EPSILON (mod p) folds its top into a sum below 2^42.
    """
    x = state.movedim(dim, -1)
    mt = _mds_matrix_t(x.device)
    acc_lo = ((x & gl.MASK32).double() @ mt).to(torch.int64)
    acc_hi = (gl._lsr32(x).double() @ mt).to(torch.int64)
    low = torch.add(acc_lo, acc_hi >> 32, alpha=gl.EPSILON)  # < 2^42
    s = acc_hi.bitwise_left_shift_(32).add_(low)
    s.add_(gl._wrapped(s, low), alpha=gl.EPSILON)
    return gl._canonicalize_(s).movedim(-1, dim)


# On the CPU the plain permutation runs in blocks of this many states: its
# elementwise passes then work on 384 KB, in the core's cache, not on the
# whole batch.
CPU_BLOCK_STATES = 4096


def permute(state: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch Poseidon permutation over [..., 12] tensors (any
    device): 4 full, 22 partial, 4 full rounds."""
    block = CPU_BLOCK_STATES
    if not state.is_cuda and state.numel() > block * SPONGE_WIDTH:
        flat = state.reshape(-1, SPONGE_WIDTH)
        return torch.cat([
            _permute_block(flat[i : i + block]) for i in range(0, flat.shape[0], block)
        ]).reshape(state.shape)
    return _permute_block(state)


def _permute_block(state: torch.Tensor) -> torch.Tensor:
    rc = _round_constants(state.device)
    h = HALF_N_FULL_ROUNDS
    for rnd in range(N_ROUNDS):
        state = gl.add(state, rc[rnd])
        if rnd < h or rnd >= h + N_PARTIAL_ROUNDS:
            state = _sbox(state)
        else:
            state = state.clone()
            state[..., 0] = _sbox(state[..., 0])
        state = _mds_layer(state)
    return state


def _permute_dispatch(state: torch.Tensor) -> torch.Tensor:
    """One absorb step's permutation: the CUDA kernel for a tensor on the
    card (``permute_cuda`` launches or raises), the plain version for a
    tensor on the CPU."""
    from .poseidon_cuda import permute_cuda

    return permute_cuda(state)


def hash_n_to_m_no_pad(
    inputs: torch.Tensor, num_outputs: int = 4, permutation=_permute_dispatch
) -> torch.Tensor:
    """Chained sponge over [..., n] inputs -> [..., num_outputs].

    Zero-initialized width-12 state, overwrite-absorb in rate-8 chunks,
    ``permutation`` after each chunk, squeeze from the front.  ``inputs`` may
    be a strided view (e.g. a transposed LDE); only rate-wide slices are
    copied.
    """
    n = inputs.shape[-1]
    batch = inputs.shape[:-1]
    state = torch.zeros(batch + (SPONGE_WIDTH,), dtype=torch.int64, device=inputs.device)
    for start in range(0, n, SPONGE_RATE):
        chunk = inputs[..., start : start + SPONGE_RATE]
        state[..., : chunk.shape[-1]] = chunk
        state = permutation(state)
    assert num_outputs <= SPONGE_WIDTH
    return state[..., :num_outputs].contiguous()  # drop the 12-wide state


def hash_no_pad(inputs: torch.Tensor, fused_sponge: bool = False) -> torch.Tensor:
    """4-limb digest of [..., n] inputs (plonky2 ``hash_n_to_hash_no_pad``).

    ``fused_sponge`` routes a tensor on the card to the one-launch sponge
    kernel instead of the chained permutation kernel."""
    if fused_sponge and inputs.is_cuda:
        from .poseidon_cuda import hash_no_pad_cuda

        flat = inputs.reshape(-1, inputs.shape[-1]) if inputs.dim() != 2 else inputs
        return hash_no_pad_cuda(flat).reshape(inputs.shape[:-1] + (4,))
    return hash_n_to_m_no_pad(inputs, 4)


def hash_pad(inputs: torch.Tensor) -> torch.Tensor:
    """Padded hash: append 1, zero-fill until len % 12 == 11, append 1."""
    n = inputs.shape[-1]
    batch = inputs.shape[:-1]
    padded_len = n + 1
    while (padded_len + 1) % SPONGE_WIDTH != 0:
        padded_len += 1
    padded_len += 1
    pad = torch.zeros(batch + (padded_len - n,), dtype=torch.int64, device=inputs.device)
    pad[..., 0] = 1
    pad[..., -1] = 1
    return hash_no_pad(torch.cat([inputs, pad], dim=-1))


def two_to_one(left: torch.Tensor, right: torch.Tensor) -> torch.Tensor:
    """Compress two [..., 4] digests into one (internal Merkle nodes)."""
    return hash_no_pad(torch.cat([left, right], dim=-1))


# ---------------------------------------------------------------------------
# Scalar (Python int) functions — host-side witness generation, the
# Fiat-Shamir transcript and exactness tests.  ``permute_s`` and
# ``hash_n_to_m_no_pad_plain_s`` are exact Python; ``permute_host`` and
# ``hash_n_to_m_no_pad_s`` call the host C++ (``native/``).
# ---------------------------------------------------------------------------

_P = gl.P_INT


def _sbox_s(x: int) -> int:
    x2 = x * x % _P
    x3 = x2 * x % _P
    return x3 * x3 % _P * x % _P


def permute_s(state):
    """Scalar reference permutation over a length-12 list of ints."""
    state = [int(x) for x in state]
    for rnd in range(N_ROUNDS):
        rcs = ALL_ROUND_CONSTANTS[rnd * SPONGE_WIDTH : (rnd + 1) * SPONGE_WIDTH]
        state = [(s + c) % _P for s, c in zip(state, rcs)]
        if rnd < HALF_N_FULL_ROUNDS or rnd >= HALF_N_FULL_ROUNDS + N_PARTIAL_ROUNDS:
            state = [_sbox_s(s) for s in state]
        else:
            state[0] = _sbox_s(state[0])
        state = [sum(map(operator.mul, row, state)) % _P for row in _MDS_INT]
    return state


def permute_host(state):
    """Scalar permutation through the host C++ (``native/poseidon_native.cpp``):
    the transcript's duplex.  ``permute_s`` is its plain version."""
    return [int(x) for x in native_permute_batch([state])[0]]


def hash_n_to_m_no_pad_s(inputs, num_outputs=4):
    """Scalar sponge; four outputs (every digest) go through the host C++
    sponge, other counts through ``hash_n_to_m_no_pad_plain_s``."""
    if num_outputs == 4:
        return list(native_hash_no_pad([int(x) for x in inputs]))
    return hash_n_to_m_no_pad_plain_s(inputs, num_outputs)


def hash_n_to_m_no_pad_plain_s(inputs, num_outputs=4):
    """The sponge in Python ints over ``permute_s``: the plain version of the
    host C++ sponge."""
    inputs = [int(x) for x in inputs]
    state = [0] * SPONGE_WIDTH
    for start in range(0, len(inputs), SPONGE_RATE):
        chunk = inputs[start : start + SPONGE_RATE]
        state[: len(chunk)] = chunk
        state = permute_s(state)
    return state[:num_outputs]


def hash_no_pad_s(inputs):
    return hash_n_to_m_no_pad_s(inputs, 4)


def hash_pad_s(inputs):
    inputs = [int(x) for x in inputs] + [1]
    while (len(inputs) + 1) % SPONGE_WIDTH != 0:
        inputs.append(0)
    inputs.append(1)
    return hash_no_pad_s(inputs)


def two_to_one_s(left, right):
    return hash_no_pad_s(list(left) + list(right))
