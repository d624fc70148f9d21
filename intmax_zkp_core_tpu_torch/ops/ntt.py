"""NTT / inverse NTT / coset LDE over Goldilocks.

The polynomial engine under the prover's commitments and quotient,
batch-first ``[..., n]`` so many polynomials transform at once.  ``ntt`` and
``intt`` launch the CUDA kernel (``ops/ntt_cuda.py::ntt_cuda``) for a tensor
on the card and take the plain version, ``_ntt_impl``, for a tensor on the
CPU.  The plain version is one formulation: bit-reversal gather followed by
log2(n) radix-2 butterfly stages.  All arithmetic is exact mod p, so the
values equal those of any other NTT formulation bit for bit.

Order convention: ``ntt`` maps coefficients -> evaluations at powers of the
canonical 2^k-th root of unity, natural order; NTT(a)[i] = sum_j a_j w^(ij).
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

from . import goldilocks as gl

P = gl.P_INT


def _root_scalar(log_n: int, inverse: bool) -> int:
    w = gl.primitive_root_of_unity(log_n)
    return pow(w, P - 2, P) if inverse else w


@lru_cache(maxsize=128)
def _twiddle_tables(log_n: int, inverse: bool, device: torch.device):
    """(bit-reversal permutation [n], per-stage twiddles) on ``device``.
    Stage s (1-based) uses the first 2^(s-1) powers of w_n^(n / 2^s)."""
    n = 1 << log_n
    idx = np.arange(n, dtype=np.int64)
    rev = np.zeros(n, dtype=np.int64)
    for b in range(log_n):
        rev |= ((idx >> b) & 1) << (log_n - 1 - b)
    w_n = _root_scalar(log_n, inverse)
    tables = []
    for s in range(1, log_n + 1):
        m = 1 << s
        tables.append(gl.powers(pow(w_n, n // m, P), m // 2, device))
    return torch.from_numpy(rev).to(device), tables


# On the CPU the plain transform takes its rows in blocks of about this many
# elements: each radix-2 stage's passes then work on 512 KB, in the core's
# cache, not on the whole matrix.
CPU_BLOCK_ELEMENTS = 1 << 16


def _ntt_impl(a: torch.Tensor, inverse: bool) -> torch.Tensor:
    n = a.shape[-1]
    rows = max(1, CPU_BLOCK_ELEMENTS // n)
    if not a.is_cuda and a.numel() > rows * n:
        flat = a.reshape(-1, n)
        return torch.cat([
            _ntt_rows(flat[i : i + rows], inverse) for i in range(0, flat.shape[0], rows)
        ]).reshape(a.shape)
    return _ntt_rows(a, inverse)


def _ntt_rows(a: torch.Tensor, inverse: bool) -> torch.Tensor:
    orig_shape = a.shape
    n = orig_shape[-1]
    log_n = n.bit_length() - 1
    assert 1 << log_n == n, "length must be a power of two"
    rev, tables = _twiddle_tables(log_n, inverse, a.device)
    x = a[..., rev]
    for s in range(1, log_n + 1):
        m = 1 << s
        half = m // 2
        x = x.reshape(orig_shape[:-1] + (n // m, m))
        even = x[..., :half]
        t = gl.mul(x[..., half:], tables[s - 1])
        x = torch.cat([gl.add(even, t), gl.sub(even, t)], dim=-1)
    x = x.reshape(orig_shape)
    if inverse:
        x = gl.mul(x, gl.i64(pow(n, P - 2, P)))
    return x


def _ntt_dispatch(a: torch.Tensor, inverse: bool) -> torch.Tensor:
    """The transform of every row of [..., n] through ``ntt_cuda``: the
    kernel for a tensor on the card (it launches or raises), the plain
    version for a tensor on the CPU."""
    from .ntt_cuda import ntt_cuda

    n = a.shape[-1]
    return ntt_cuda(a.reshape(-1, n).contiguous(), inverse).reshape(a.shape)


def ntt(a, device=None) -> torch.Tensor:
    """Coefficients -> evaluations on the size-n subgroup (natural order)."""
    return _ntt_dispatch(gl.as_field(a, device), False)


def intt(a, device=None) -> torch.Tensor:
    """Evaluations -> coefficients."""
    return _ntt_dispatch(gl.as_field(a, device), True)


@lru_cache(maxsize=64)
def _shift_powers(n: int, shift: int, device: torch.device) -> torch.Tensor:
    return gl.powers(shift, n, device)


def coset_lde(
    a, rate_bits: int, shift: int = gl.MULTIPLICATIVE_GROUP_GENERATOR, device=None
) -> torch.Tensor:
    """Low-degree extension: evaluate the polynomial with coefficients ``a``
    (shape [..., n]) on the coset ``shift * H`` of the 2^rate_bits-times
    larger subgroup H (plonky2's ``coset_fft`` with ``F::coset_shift``)."""
    a = gl.as_field(a, device)
    n = a.shape[-1]
    lde_n = n << rate_bits
    shifted = gl.mul(a, _shift_powers(n, shift % P, a.device))
    padded = torch.zeros(a.shape[:-1] + (lde_n,), dtype=torch.int64, device=a.device)
    padded[..., :n] = shifted
    return ntt(padded)


def coset_ilde(
    evals, rate_bits: int, shift: int = gl.MULTIPLICATIVE_GROUP_GENERATOR, device=None
) -> torch.Tensor:
    """Inverse of coset_lde: recover the n low-order coefficients."""
    evals = gl.as_field(evals, device)
    lde_n = evals.shape[-1]
    n = lde_n >> rate_bits
    coeffs = intt(evals)
    inv_shift = pow(shift % P, P - 2, P)
    unshifted = gl.mul(coeffs, _shift_powers(lde_n, inv_shift, evals.device))
    return unshifted[..., :n]


def eval_poly_at(coeffs: torch.Tensor, x) -> torch.Tensor:
    """Horner evaluation of [..., n] coefficient tensors at scalar/batched x
    (base field)."""
    n = coeffs.shape[-1]
    acc = coeffs[..., n - 1]
    for i in range(n - 2, -1, -1):
        acc = gl.add(gl.mul(acc, x), coeffs[..., i])
    return acc


def eval_poly_at_ext(coeffs: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Horner evaluation of base-field coefficients [..., n] at an
    extension-field point x [..., 2]."""
    n = coeffs.shape[-1]
    acc = gl.ext_from_base(coeffs[..., n - 1])
    for i in range(n - 2, -1, -1):
        acc = gl.ext_add(gl.ext_mul(acc, x), gl.ext_from_base(coeffs[..., i]))
    return acc
