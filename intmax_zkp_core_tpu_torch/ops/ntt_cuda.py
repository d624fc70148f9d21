"""NTT and inverse NTT over Goldilocks as a hand-written CUDA kernel, with its
plain PyTorch version.

``ntt_cuda(x [B, n], inverse)`` -> ``[B, n]``, natural order in and out,
bit-identical to ``ops/ntt.py::ntt`` / ``intt`` (the inverse includes the
1/n scale).  Replaces the JAX package's ``ops/ntt_pallas.py::ntt_pallas``.
The kernel (``csrc/ntt.cu``) is one local transform of up to 2^11 points
over strided sequences: the plain version's radix-2 stages taken three at
a time in registers, with one exchange through shared memory between such
passes.  The wrapper makes of it, for n <= 2^11, one launch with a row per
sequence, and above that the four-step transform of the TPU kernel
(n = n1 * n2): one launch over the columns with the twiddle w^(i2 * k1) (1/n
folded into the inverse's table), one over the rows writing transposed.
Every power of two from 1 to 2^22 is taken on the card, which never takes the
plain NTT; a longer row raises.

Tables, made once per (size, direction, device) on the device and cached:
the powers of the transform's root (``root_powers``), the four-step twiddle
matrix (``fourstep_twiddles``); the 8th roots of unity of a direction
(``eighth_roots``) go to the kernel as arguments.

The plain version is ``ops/ntt.py::_ntt_impl``.  The wrapper takes it only
for a tensor on the CPU; for a CUDA tensor it launches the kernel or raises.
"""

from __future__ import annotations

from functools import lru_cache

import torch

from . import cuda_build as cb
from . import goldilocks as gl
from .ntt import _ntt_impl, _root_scalar

P = gl.P_INT
LOCAL_LOG_MAX = 11  # the longest sequence a block transforms
MAX_LOG_N = 2 * LOCAL_LOG_MAX
BLOCK_LOG_ELEMS = 12  # a block holds at most 2^12 u64 (32 KB of shared memory)
COALESCED_LOG_GROUP = 3  # 8 neighbouring strided sequences: 64-byte segments
MAX_BATCH = 65535  # rows of a four-step launch ride on the grid's second axis


def ntt_plain(x: torch.Tensor, inverse: bool) -> torch.Tensor:
    """Plain PyTorch version of ``ntt_cuda``, on whatever device."""
    return _ntt_impl(x, inverse)


def launches_for(n: int) -> int:
    """Kernel launches of one ``ntt_cuda`` call at length ``n``."""
    return 1 if n.bit_length() - 1 <= LOCAL_LOG_MAX else 2


def passes_for(log_len: int) -> tuple:
    """The kernel's register passes of a length-2^log_len transform: the
    number of stages of each, in order (the first takes what is left over
    from threes; a length below 8 is one pass of all its stages)."""
    if log_len <= 3:
        return (log_len,)
    n_passes = (log_len + 2) // 3
    return (log_len - 3 * (n_passes - 1),) + (3,) * (n_passes - 1)


@lru_cache(maxsize=64)
def root_powers(log_len: int, inverse: bool, device: torch.device) -> torch.Tensor:
    """[N]: w_N^i for the N-th root of unity of ``ops/ntt.py::_root_scalar``
    (its inverse for the inverse transform), N = 2^log_len."""
    return gl.powers(_root_scalar(log_len, inverse), 1 << log_len, device).contiguous()


@lru_cache(maxsize=2)
def eighth_roots(inverse: bool) -> tuple:
    """(w_4, w_8, w_8^3) of a direction, the twiddles inside the kernel's
    three-stage passes; w_8^2 = w_4 is checked."""
    w4, w8 = _root_scalar(2, inverse), _root_scalar(3, inverse)
    if w8 * w8 % P != w4:
        raise RuntimeError("the 8th root of unity does not square to the 4th")
    return w4, w8, pow(w8, 3, P)


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


@lru_cache(maxsize=8)
def _sm_count(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def group_log(log_len: int, n_seq: int, batch: int, strided: bool, sms: int) -> int:
    """log2 of the sequences a block takes: as many as its shared memory and
    the sequences allow, then fewer while the grid has under two blocks per
    SM, but never under 8 where a sequence is strided in memory (a warp then
    still moves 64-byte segments)."""
    log_group = min(BLOCK_LOG_ELEMS - log_len, max(n_seq - 1, 0).bit_length())
    floor = min(log_group, COALESCED_LOG_GROUP) if strided else 0
    while log_group > floor and (((n_seq - 1) >> log_group) + 1) * batch < 2 * sms:
        log_group -= 1
    return log_group


def _local(src, dst, log_len, n_seq, batch, batch_stride, in_strides, out_strides, inverse,
           post=None, scale=None):
    """One launch of the local transform (``csrc/ntt.cu``); strides are
    (sequence, element) pairs, one of which is 1."""
    device = src.device
    in_rows, out_rows = in_strides[1] == 1, out_strides[1] == 1
    layout = {(True, True): 0, (False, False): 1, (True, False): 2}[in_rows, out_rows]
    log_group = group_log(log_len, n_seq, batch, layout != 0, _sm_count(device))
    cb.launch("ntt_cuda", "ntt_local", device,
              src.data_ptr(), dst.data_ptr(), log_len, log_group, n_seq, batch, batch_stride,
              layout, in_strides[0 if in_rows else 1], out_strides[0 if out_rows else 1],
              root_powers(log_len, inverse, device).data_ptr(),
              post[0].data_ptr() if post is not None else None,
              post[1] if post is not None else 0,
              0 if scale is None else scale, int(scale is not None), *eighth_roots(inverse))


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
    if B >= 1 << 31:
        raise ValueError(f"{name} takes fewer than 2^31 rows, got {B}")
    if log_n <= LOCAL_LOG_MAX:
        # every row one sequence: one launch, the inverse's 1/n as the scale
        scale = pow(n, P - 2, P) if inverse else None
        _local(x, out, log_n, B, 1, 0, (n, 1), (n, 1), inverse, scale=scale)
        return out
    if B > MAX_BATCH:
        raise ValueError(f"{name} takes at most {MAX_BATCH} rows at n > 2^{LOCAL_LOG_MAX}, got {B}")
    log_n1 = log_n // 2
    log_n2 = log_n - log_n1
    n1, n2 = 1 << log_n1, 1 << log_n2
    mid = torch.empty_like(x)
    # columns i2 of [n1, n2]: length-n1 transforms, times w^(i2 * k1) (and 1/n)
    _local(x, mid, log_n1, n2, B, n, (1, n2), (1, n2), inverse,
           post=(fourstep_twiddles(log_n1, log_n2, inverse, device), n2))
    # rows k1: length-n2 transforms, X[k1 + n1 * k2] written at k2 * n1 + k1
    _local(mid, out, log_n2, n1, B, n, (n2, 1), (1, n1), inverse)
    return out
