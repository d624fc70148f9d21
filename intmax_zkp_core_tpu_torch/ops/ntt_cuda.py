"""NTT and inverse NTT over Goldilocks as a hand-written CUDA kernel, with its
plain PyTorch version.

``ntt_cuda(x [B, n], inverse)`` -> ``[B, n]``, natural order in and out,
bit-identical to ``ops/ntt.py::ntt`` / ``intt`` (the inverse includes the
1/n scale).  Replaces the JAX package's ``ops/ntt_pallas.py::ntt_pallas``.
The kernel (``csrc/ntt.cu``) is one local transform over strided sequences
in shared memory; the wrapper makes of it, for n <= 2^11, one launch with a
row per sequence, and above that the four-step transform of the TPU kernel
(n = n1 * n2): one launch over the columns with the twiddle w^(i2 * k1) (1/n
folded into the inverse's table), one over the rows writing transposed.
Every power of two from 1 to 2^22 is taken on the card, which never takes the
plain NTT; a longer row raises.

Tables, made once per (size, direction, device) on the device and cached:
the radix-2 stage twiddles of the plain version, concatenated, and the
four-step twiddle matrix.

The plain version is ``ops/ntt.py::_ntt_impl``.  The wrapper takes it only
for a tensor on the CPU; for a CUDA tensor it launches the kernel or raises.
"""

from __future__ import annotations

from functools import lru_cache

import torch

from . import cuda_build as cb
from . import goldilocks as gl
from .ntt import _ntt_impl, _root_scalar, _twiddle_tables

P = gl.P_INT
LOCAL_LOG_MAX = 11  # the longest sequence a block transforms (2^11 u64 = 16 KB)
MAX_LOG_N = 2 * LOCAL_LOG_MAX
BLOCK_LOG_ELEMS = 12  # a block holds at most 2^12 u64 (32 KB of shared memory)
MAX_LOG_GROUP = 4  # at most 16 neighbouring sequences per block
MAX_BATCH = 65535  # rows of a four-step launch ride on the grid's second axis


def ntt_plain(x: torch.Tensor, inverse: bool) -> torch.Tensor:
    """Plain PyTorch version of ``ntt_cuda``, on whatever device."""
    return _ntt_impl(x, inverse)


def launches_for(n: int) -> int:
    """Kernel launches of one ``ntt_cuda`` call at length ``n``."""
    return 1 if n.bit_length() - 1 <= LOCAL_LOG_MAX else 2


@lru_cache(maxsize=64)
def _stage_twiddles(log_len: int, inverse: bool, device: torch.device) -> torch.Tensor:
    """The plain version's per-stage twiddle tables of a length-2^log_len
    transform, concatenated: stage s at offset 2^(s-1) - 1 ([1] for length 1,
    so that the kernel always gets a pointer)."""
    tables = _twiddle_tables(log_len, inverse, device)[1]
    if not tables:
        return torch.ones(1, dtype=torch.int64, device=device)
    return torch.cat(tables).contiguous()


@lru_cache(maxsize=32)
def fourstep_twiddles(log_n1: int, log_n2: int, inverse: bool, device: torch.device) -> torch.Tensor:
    """[n1, n2]: w^(i2 * k1) at [k1, i2] for w the n-th root of unity (its
    inverse, and times 1/n, for the inverse transform), built row block by
    row block: rows [2^b, 2^(b+1)) are rows [0, 2^b) times w^(2^b * i2)."""
    n2 = 1 << log_n2
    w = _root_scalar(log_n1 + log_n2, inverse)
    first = pow(1 << (log_n1 + log_n2), P - 2, P) if inverse else 1
    table = torch.full((1, n2), gl.i64(first), dtype=torch.int64, device=device)
    for b in range(log_n1):
        step = gl.powers(pow(w, 1 << b, P), n2, device)
        table = torch.cat([table, gl.mul(table, step)])
    return table.contiguous()


def _local(src, dst, log_len, n_seq, batch, batch_stride, in_strides, out_strides,
           stage_tw, post=None, scale=None):
    """One launch of the local transform (``csrc/ntt.cu``)."""
    log_group = min(MAX_LOG_GROUP, BLOCK_LOG_ELEMS - log_len, max(n_seq - 1, 0).bit_length())
    post_tw, post_strides = post if post is not None else (None, (0, 0))
    cb.launch("ntt_cuda", "ntt_local", src.device,
              src.data_ptr(), dst.data_ptr(), log_len, log_group, n_seq, batch, batch_stride,
              *in_strides, *out_strides, stage_tw.data_ptr(),
              post_tw.data_ptr() if post_tw is not None else None, *post_strides,
              0 if scale is None else scale, int(scale is not None))


def ntt_cuda(x: torch.Tensor, inverse: bool = False) -> torch.Tensor:
    """[B, n] int64 bit patterns, n a power of two (up to 2^22 on the card) -> the NTT
    (``inverse``: the inverse NTT, scaled by 1/n) of every row, natural
    order.  CUDA tensor: one launch for n <= 2^11, two above (or an
    exception).  CPU tensor: the plain version."""
    name = "ntt_cuda"
    cb.require_field(name, x=x)
    if x.dim() != 2:
        raise ValueError(f"{name} wants [B, n], got {tuple(x.shape)}")
    B, n = x.shape
    log_n = n.bit_length() - 1
    if n < 1 or n != 1 << log_n:
        raise ValueError(f"{name} wants a power-of-two length, got {n}")
    if not x.is_cuda:
        return ntt_plain(x, inverse)
    if log_n > MAX_LOG_N:
        raise ValueError(f"{name} takes n up to 2^{MAX_LOG_N} on the card, got 2^{log_n}")
    cb.require_contiguous(name, x=x)
    out = torch.empty_like(x)
    if B == 0:
        return out
    device = x.device
    if log_n <= LOCAL_LOG_MAX:
        # every row one sequence: one launch, the inverse's 1/n as the scale
        scale = pow(n, P - 2, P) if inverse else None
        _local(x, out, log_n, B, 1, 0, (n, 1), (n, 1),
               _stage_twiddles(log_n, inverse, device), scale=scale)
        return out
    if B > MAX_BATCH:
        raise ValueError(f"{name} takes at most {MAX_BATCH} rows at n > 2^{LOCAL_LOG_MAX}, got {B}")
    log_n1 = log_n // 2
    log_n2 = log_n - log_n1
    n1, n2 = 1 << log_n1, 1 << log_n2
    mid = torch.empty_like(x)
    # columns i2 of [n1, n2]: length-n1 transforms, times w^(i2 * k1) (and 1/n)
    _local(x, mid, log_n1, n2, B, n, (1, n2), (1, n2), _stage_twiddles(log_n1, inverse, device),
           post=(fourstep_twiddles(log_n1, log_n2, inverse, device), (n2, 1)))
    # rows k1: length-n2 transforms, X[k1 + n1 * k2] written at k2 * n1 + k1
    _local(mid, out, log_n2, n1, B, n, (n2, 1), (1, n1), _stage_twiddles(log_n2, inverse, device))
    return out
