"""The initial FRI evaluation vector G, as a hand-written CUDA kernel with its
plain PyTorch version.

    G(x) = (comb1(x) - comb1(zeta)) / (x - zeta)
         + (comb2(x) - comb2(g*zeta)) / (x - g*zeta)

over F_p[X] / (X^2 - 7), at every point x of the LDE coset.

``fri_initial_cuda(comb1, comb2, xs, zetas, gzetas, c1z, c2gz)``: comb1, comb2
[K, L, 2], xs [L], the per-proof scalars [K, 2] -> G [K, L, 2].  Replaces the
JAX package's ``ops/fri_init_pallas.py::fri_initial_pallas_batched``.
Because x lies in the base field each extension inverse is one base-field
inverse of the norm ``(x - z0)^2 - 7*z1^2``.  In the kernel
(``csrc/fri_init.cu``) a thread takes a few points of one proof
(``batch_layout``), and a block inverts the two norms of all its points
together (``batch_inv_loose`` of ``csrc/goldilocks.cuh``: one Fermat chain a
block); a zero norm gives a zero term at that point, as in the plain version.

The plain version is ``fri_initial_plain``: two ``gl.ext_inv``, two
``gl.ext_mul``, one ``gl.ext_add``.  The wrapper takes it only for tensors on
the CPU; for CUDA tensors it launches the kernel or raises.
"""

from __future__ import annotations

import torch

from . import cuda_build as cb
from . import goldilocks as gl


def fri_initial_plain(comb1, comb2, xs, zetas, gzetas, c1z, c2gz) -> torch.Tensor:
    """Plain PyTorch version of ``fri_initial_cuda``, on whatever device."""
    xs_ext = torch.stack([xs, torch.zeros_like(xs)], dim=-1)  # [L, 2]

    def sub_const_ext(arr, cst):  # arr [..., L, 2] - cst [K, 2] -> [K, L, 2]
        return gl.sub(arr, cst[:, None, :])

    denom1 = gl.ext_inv(sub_const_ext(xs_ext, zetas))
    denom2 = gl.ext_inv(sub_const_ext(xs_ext, gzetas))
    num1 = sub_const_ext(comb1, c1z)
    num2 = sub_const_ext(comb2, c2gz)
    return gl.ext_add(gl.ext_mul(num1, denom1), gl.ext_mul(num2, denom2))


def fri_initial_cuda(comb1, comb2, xs, zetas, gzetas, c1z, c2gz) -> torch.Tensor:
    """comb1, comb2 [K, L, 2], xs [L], zetas, gzetas, c1z, c2gz [K, 2] (int64
    bit patterns) -> G [K, L, 2].  CUDA tensors: one launch per 65,535
    proofs (or an exception).  CPU tensors: the plain version."""
    name = "fri_initial_cuda"
    scalars = {"zetas": zetas, "gzetas": gzetas, "c1z": c1z, "c2gz": c2gz}
    cb.require_field(name, comb1=comb1, comb2=comb2, xs=xs, **scalars)
    if comb1.dim() != 3 or comb1.shape[2] != 2 or comb2.shape != comb1.shape:
        raise ValueError(
            f"{name} wants comb1 and comb2 [K, L, 2], got {tuple(comb1.shape)} "
            f"and {tuple(comb2.shape)}"
        )
    K, L = comb1.shape[0], comb1.shape[1]
    if tuple(xs.shape) != (L,):
        raise ValueError(f"{name} wants xs [{L}], got {tuple(xs.shape)}")
    for arg, t in scalars.items():
        if tuple(t.shape) != (K, 2):
            raise ValueError(f"{name} wants {arg} [{K}, 2], got {tuple(t.shape)}")
    cb.require_same_device(name, comb1, comb2=comb2, xs=xs, **scalars)
    if not comb1.is_cuda:
        return fri_initial_plain(comb1, comb2, xs, zetas, gzetas, c1z, c2gz)
    cb.require_contiguous(name, comb1=comb1, comb2=comb2, xs=xs, **scalars)
    if comb1.data_ptr() % 16 or comb2.data_ptr() % 16:
        raise ValueError(f"{name} reads 16-byte pairs: comb1 and comb2 must be 16-byte aligned")
    if K > cb.MAX_GRID_YZ:  # proofs ride on the grid's second axis
        return torch.cat([fri_initial_cuda(comb1[a:b], comb2[a:b], xs, zetas[a:b], gzetas[a:b],
                                           c1z[a:b], c2gz[a:b]) for a, b in cb.grid_chunks(K)])
    out = torch.empty_like(comb1)
    if out.numel() == 0:
        return out
    cb.launch(name, "fri_initial", comb1.device,
              comb1.data_ptr(), comb2.data_ptr(), xs.data_ptr(), zetas.data_ptr(),
              gzetas.data_ptr(), c1z.data_ptr(), c2gz.data_ptr(), out.data_ptr(), K, L)
    return out


def batch_layout() -> tuple:
    """(threads a block, points a thread) of the kernel; a thread's points lie
    one block width apart.  Needs the built library (the card's machine)."""
    lib = cb.load()
    return lib.fri_initial_threads(), lib.fri_initial_points()
