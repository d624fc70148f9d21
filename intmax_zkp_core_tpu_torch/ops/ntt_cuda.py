"""NTT and inverse NTT over Goldilocks as a hand-written CUDA kernel, with its
plain PyTorch version.

``ntt_cuda(x [B, n], inverse)`` -> ``[B, n]``, natural order in and out,
bit-identical to ``ops/ntt.py::ntt`` / ``intt`` (the inverse includes the
1/n scale).  Replaces the JAX package's ``ops/ntt_pallas.py::ntt_pallas``.
The kernel (``csrc/ntt.cu``) is one local transform of up to 2^11 points
over strided sequences: the plain version's radix-2 stages taken three at
a time in registers, with one exchange through shared memory between such
passes.  The wrapper makes of it (``_transform``), for n <= 2^11, one launch
with a row per sequence; up to 2^22 the four-step transform of the TPU
kernel (n = n1 * n2): one launch over the columns with the twiddle
w^(i2 * k1) (1/n folded into the inverse's table), one over the rows writing
transposed; above 2^22, where the JAX package leaves the TPU kernel for
XLA, an outer four-step with n1 = 2^11: the column launch (1/n1 in the
table), the rows' transforms of length n2 by the four-step above, and the
kernel's transposed copy (``ntt_transpose``).  Every power of two up to the
field's two-adicity, 2^32, is taken on the card, at any row count (the rows
of a four-step launch ride on the grid's second axis: more than 65,535 go
over several launches), so only memory limits it; the card never takes the
plain NTT.  ``plan`` lists a call's launches.

Tables, made once per (size, direction, device) on the device and cached:
the powers of the transform's root (``root_powers``), the four-step twiddle
matrix (``fourstep_twiddles``; the outer step's, as large as a row,
``outer_twiddles``, the last two kept); the 8th roots of unity of a
direction (``eighth_roots``) go to the kernel as arguments.

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
TWO_ADICITY = 32  # the longest transform the field has roots of unity for: 2^32
BLOCK_LOG_ELEMS = 12  # a block holds at most 2^12 u64 (32 KB of shared memory)
COALESCED_LOG_GROUP = 3  # 8 neighbouring strided sequences: 64-byte segments


def ntt_plain(x: torch.Tensor, inverse: bool) -> torch.Tensor:
    """Plain PyTorch version of ``ntt_cuda``, on whatever device."""
    return _ntt_impl(x, inverse)


def launches_for(n: int, rows: int = 1) -> int:
    """Kernel launches of one ``ntt_cuda`` call on [rows, n]."""
    return len(plan(rows, n))


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


def twiddle_table(log_n1: int, log_n2: int, inverse: bool, device, log_scale=None):
    """[n1, n2]: w^(i2 * k1) at [k1, i2] for w the n-th root of unity (its
    inverse, and times 1/2^log_scale, by default 1/n, for the inverse
    transform), built row block by row block: rows [2^b, 2^(b+1)) are rows
    [0, 2^b) times w^(2^b * i2), the square of the step before."""
    n2 = 1 << log_n2
    w = _root_scalar(log_n1 + log_n2, inverse)
    if log_scale is None:
        log_scale = log_n1 + log_n2
    first = pow(1 << log_scale, P - 2, P) if inverse else 1
    table = torch.full((1, n2), gl.i64(first), dtype=torch.int64, device=device)
    step = gl.powers(w, n2, device)
    for _ in range(log_n1):
        table = torch.cat([table, gl.mul(table, step)])
        step = gl.square(step)
    return table.contiguous()


@lru_cache(maxsize=32)
def fourstep_twiddles(log_n1: int, log_n2: int, inverse: bool, device: torch.device) -> torch.Tensor:
    """``twiddle_table`` of a four-step of at most 2^22 points (the inverse's
    1/n in it), cached."""
    return twiddle_table(log_n1, log_n2, inverse, device)


@lru_cache(maxsize=2)
def outer_twiddles(log_n1: int, log_n2: int, inverse: bool, device: torch.device) -> torch.Tensor:
    """``twiddle_table`` of the outer four-step above 2^22 (the inverse's
    1/n1 alone in it: the rows' transforms scale by 1/n2), cached: as large
    as a row, so only the last two are kept."""
    return twiddle_table(log_n1, log_n2, inverse, device, log_scale=log_n1)


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


class _Launches:
    """The launches of ``_transform`` on the card: the local kernel, the
    transposed copy and the tables they read."""

    local = staticmethod(_local)

    @staticmethod
    def transpose(src, dst, rows: int, cols: int) -> None:
        """dst [B, cols, rows] <- src [B, rows, cols] transposed."""
        cb.launch("ntt_cuda", "ntt_transpose", src.device, src.data_ptr(), dst.data_ptr(),
                  rows, cols, src.shape[0])

    @staticmethod
    def twiddles(log_n1, log_n2, inverse, device, outer=False):
        return (outer_twiddles if outer else fourstep_twiddles)(log_n1, log_n2, inverse, device)


class _Plan:
    """``_transform``'s launches recorded, not run (tensors on "meta")."""

    def __init__(self):
        self.launches = []

    def local(self, src, dst, log_len, n_seq, batch, *args, **kwargs) -> None:
        self.launches.append(("local", log_len, n_seq, batch))

    def transpose(self, src, dst, rows: int, cols: int) -> None:
        self.launches.append(("transpose", rows, cols, src.shape[0]))

    @staticmethod
    def twiddles(log_n1, log_n2, inverse, device, outer=False):
        return torch.empty((1 << log_n1, 1 << log_n2), dtype=torch.int64, device="meta")


def _transform(x, out, log_n: int, inverse: bool, ops, local_log_max: int = LOCAL_LOG_MAX,
               max_rows: int = cb.MAX_GRID_YZ) -> None:
    """out [B, 2^log_n] <- the NTT (inverse NTT) of every row of x, both
    contiguous, through ``ops``' launches: the local transform of up to
    2^local_log_max points, the transposed copy and the twiddle tables (the
    card's ``_Launches``; a test may pass smaller limits and launches of its
    own).  Rows ride on the grid's second axis at most ``max_rows`` at a
    time."""
    B = x.shape[0]
    n = 1 << log_n
    if log_n <= local_log_max:
        # every row one sequence: one launch, the inverse's 1/n as the scale
        if B >= 1 << 31:
            raise ValueError(f"ntt_cuda takes fewer than 2^31 rows at n <= 2^{local_log_max}, "
                             f"got {B}")
        scale = pow(n, P - 2, P) if inverse else None
        ops.local(x, out, log_n, B, 1, 0, (n, 1), (n, 1), inverse, scale=scale)
        return
    chunks = [(a, min(a + max_rows, B)) for a in range(0, B, max_rows)]
    mid = torch.empty_like(x)
    if log_n <= 2 * local_log_max:
        log_n1 = log_n // 2
        log_n2 = log_n - log_n1
        n1, n2 = 1 << log_n1, 1 << log_n2
        tw = ops.twiddles(log_n1, log_n2, inverse, x.device)
        for a, b in chunks:
            # columns i2 of [n1, n2]: length-n1 transforms, times w^(i2 * k1) (and 1/n)
            ops.local(x[a:b], mid[a:b], log_n1, n2, b - a, n, (1, n2), (1, n2), inverse,
                      post=(tw, n2))
            # rows k1: length-n2 transforms, X[k1 + n1 * k2] written at k2 * n1 + k1
            ops.local(mid[a:b], out[a:b], log_n2, n1, b - a, n, (n2, 1), (1, n1), inverse)
        return
    # the outer four-step, n1 = 2^local_log_max: the rows' transforms scale by 1/n2
    log_n1, log_n2 = local_log_max, log_n - local_log_max
    n1, n2 = 1 << log_n1, 1 << log_n2
    tw = ops.twiddles(log_n1, log_n2, inverse, x.device, outer=True)
    for a, b in chunks:
        ops.local(x[a:b], mid[a:b], log_n1, n2, b - a, n, (1, n2), (1, n2), inverse,
                  post=(tw, n2))
    del tw
    rows = torch.empty_like(x)
    _transform(mid.view(B * n1, n2), rows.view(B * n1, n2), log_n2, inverse, ops,
               local_log_max, max_rows)
    del mid
    for a, b in chunks:
        ops.transpose(rows[a:b], out[a:b], n1, n2)


def plan(rows: int, n: int) -> list:
    """The kernel launches of one ``ntt_cuda`` call on [rows, n], in order:
    ("local", log2 length, sequences, batch rows) for the local transform,
    ("transpose", rows, cols, batch) for the transposed copy."""
    log_n = n.bit_length() - 1
    if n < 1 or n != 1 << log_n or log_n > TWO_ADICITY:
        raise ValueError(f"ntt_cuda wants a power-of-two length up to 2^{TWO_ADICITY}, got {n}")
    recorder = _Plan()
    x = torch.empty((rows, n), dtype=torch.int64, device="meta")
    _transform(x, torch.empty_like(x), log_n, False, recorder)
    return recorder.launches


def ntt_cuda(x: torch.Tensor, inverse: bool = False) -> torch.Tensor:
    """[B, n] int64 bit patterns, n a power of two up to 2^32 -> the NTT
    (``inverse``: the inverse NTT, scaled by 1/n) of every row, natural
    order.  CUDA tensor: the launches of ``plan`` (or an exception).  CPU
    tensor: the plain version."""
    name = "ntt_cuda"
    cb.require_field(name, x=x)
    if x.dim() != 2:
        raise ValueError(f"{name} wants [B, n], got {tuple(x.shape)}")
    B, n = x.shape
    log_n = n.bit_length() - 1
    if n < 1 or n != 1 << log_n or log_n > TWO_ADICITY:
        raise ValueError(f"{name} wants a power-of-two length up to 2^{TWO_ADICITY}, got {n}")
    if not x.is_cuda:
        return ntt_plain(x, inverse)
    cb.require_contiguous(name, x=x)
    out = torch.empty_like(x)
    if B > 0:
        _transform(x, out, log_n, inverse, _Launches)
    return out
