"""The quotient's divide: ``acc * Z_H(x)^-1`` over the evaluation domain, as a
hand-written CUDA kernel with its plain PyTorch version.

``zinv_mul_cuda(acc, z_h)``: acc [..., L], z_h [L] -> [..., L].  Replaces the
JAX package's ``ops/zinv_mul_pallas.py::zinv_mul_pallas``.  In the kernel
(``csrc/zinv_mul.cu``) a thread takes a few points (``batch_layout``), a block
inverts the z_h values of all its points together (``batch_inv_loose`` of
``csrc/goldilocks.cuh``: one Fermat chain a block), and each inverse is
multiplied into that point of every leading row.

The plain version is ``zinv_mul_plain`` = ``gl.mul(acc, gl.inv(z_h))``.  The
wrapper takes it only for a tensor on the CPU; for a CUDA tensor it launches
the kernel or raises.
"""

from __future__ import annotations

import torch

from . import cuda_build as cb
from . import goldilocks as gl


def zinv_mul_plain(acc: torch.Tensor, z_h: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of ``zinv_mul_cuda``, on whatever device."""
    return gl.mul(acc, gl.inv(z_h))


def zinv_mul_cuda(acc: torch.Tensor, z_h: torch.Tensor) -> torch.Tensor:
    """acc [..., L] * z_h [L]^-1 elementwise mod p (0^-1 = 0), int64 bit
    patterns.  CUDA tensors: one launch (or an exception).  CPU tensors: the
    plain version."""
    cb.require_field("zinv_mul_cuda", acc=acc, z_h=z_h)
    if acc.dim() < 1 or z_h.dim() != 1 or acc.shape[-1] != z_h.shape[0]:
        raise ValueError(
            f"zinv_mul_cuda wants acc [..., L] and z_h [L], got {tuple(acc.shape)} "
            f"and {tuple(z_h.shape)}"
        )
    cb.require_same_device("zinv_mul_cuda", acc, z_h=z_h)
    if not acc.is_cuda:
        return zinv_mul_plain(acc, z_h)
    cb.require_contiguous("zinv_mul_cuda", acc=acc, z_h=z_h)
    out = torch.empty_like(acc)
    L = z_h.shape[0]
    if acc.numel() == 0:
        return out
    cb.launch("zinv_mul_cuda", "zinv_mul", acc.device,
              acc.data_ptr(), z_h.data_ptr(), out.data_ptr(), acc.numel() // L, L)
    return out


def batch_layout() -> tuple:
    """(threads a block, points a thread) of the kernel; a thread's points lie
    one block width apart.  Needs the built library (the card's machine)."""
    lib = cb.load()
    return lib.zinv_mul_threads(), lib.zinv_mul_points()
