"""The permutation-argument columns (Z and the chunk partial products), as
hand-written CUDA kernels with their plain PyTorch version.

``perm_columns_cuda(wires, betas, gammas, id_vals, sigma)`` -> ``(z [K, C,
n], pp [K, C, nch-1, n], wrap [K, C])``; ``wrap`` is the product over all rows
and must be 1 for a consistent sigma.  Replaces the JAX package's
``ops/perm_columns_pallas.py::perm_columns_pallas_batched``: its Pallas
kernel (the elementwise stage) and its XLA tail (the running product of the
row quotients along n, Z and the partial products).

For CUDA tensors the whole function is ``csrc/perm_columns.cu``, in
``LAUNCHES_PER_CALL`` launches and no PyTorch operation between them: pass A,
one thread per (proof, challenge, row point), forms the factors
``w_i + beta*id_i + gamma`` and ``w_i + beta*sigma_i + gamma`` and their
products over chunks of 7 wires in one walk, takes ONE Fermat inverse of the
g total, forms the partial-product quotients ``F_pref[j] / G_pref[j] =
F_pref[j] * G_suff[j+1] / G_total`` walking back, and each block's product
scan of the row quotients; pass B scans the blocks' totals
per (proof, challenge), which gives each block's carry and ``wrap``; pass C
makes Z and the partial products.

The plain versions are ``stage1_plain`` (the elementwise stage) and
``perm_columns_plain`` (stage 1 and the log-step running product
``_finish``).  The wrapper takes the plain version only for tensors on the
CPU; for CUDA tensors it launches the kernels or raises.
"""

from __future__ import annotations

import torch

from . import cuda_build as cb
from . import goldilocks as gl
from .perm_quotient_cuda import CHUNK, n_chunks

# Launches per call for CUDA tensors: passes A, B and C.
LAUNCHES_PER_CALL = 3


def _cumprod(x: torch.Tensor) -> torch.Tensor:
    """Inclusive running product mod p along the last axis, as a log-step
    scan (exact arithmetic makes the association order irrelevant)."""
    n = x.shape[-1]
    d = 1
    while d < n:
        x = torch.cat([x[..., :d], gl.mul(x[..., d:], x[..., :-d])], dim=-1)
        d *= 2
    return x


def stage1_plain(wires, betas, gammas, id_vals, sigma):
    """The elementwise stage of ``perm_columns_plain``, on whatever device: wires
    [K, >= R, n] (the first R rows are read), betas, gammas [K, C], id_vals,
    sigma [R, n] -> (f_pref [K, C, nch, n], g_pref_inv [K, C, nch-1, n],
    row_quot [K, C, n])."""
    K, _, n = wires.shape
    C = betas.shape[1]
    R = id_vals.shape[0]
    nch = n_chunks(R)

    def chunk_prod(m):  # [nch, CHUNK, n] -> [nch, n]
        out = m[:, 0]
        for i in range(1, CHUNK):
            out = gl.mul(out, m[:, i])
        return out

    def one(w, beta, gamma):
        f_fac = gl.add(gl.add(w, gl.mul(beta, id_vals)), gamma)  # [R, n]
        g_fac = gl.add(gl.add(w, gl.mul(beta, sigma)), gamma)
        pad = nch * CHUNK - R
        if pad:
            ones = torch.ones((pad, n), dtype=torch.int64, device=w.device)
            f_fac = torch.cat([f_fac, ones], dim=0)
            g_fac = torch.cat([g_fac, ones], dim=0)
        f_ch = chunk_prod(f_fac.reshape(nch, CHUNK, n))
        g_ch = chunk_prod(g_fac.reshape(nch, CHUNK, n))
        # prefix products of f chunks; SUFFIX products of g chunks:
        # inv(G_pref[j]) = G_suff[j+1] * inv(G_total), so only the single [n]
        # total column needs the Fermat inversion
        f_pref = [f_ch[0]]
        for j in range(1, nch):
            f_pref.append(gl.mul(f_pref[-1], f_ch[j]))
        g_suff = [g_ch[nch - 1]]
        for j in range(nch - 2, -1, -1):
            g_suff.append(gl.mul(g_suff[-1], g_ch[j]))
        g_suff.reverse()
        g_total_inv = gl.inv(g_suff[0])  # [n]
        row_quot = gl.mul(f_pref[-1], g_total_inv)
        if nch > 1:
            g_pref_inv = gl.mul(torch.stack(g_suff[1:]), g_total_inv)
        else:
            # R <= CHUNK: no partial products
            g_pref_inv = torch.zeros((0, n), dtype=torch.int64, device=w.device)
        return torch.stack(f_pref), g_pref_inv, row_quot

    outs = [one(wires[k, :R], betas[k, c], gammas[k, c]) for k in range(K) for c in range(C)]
    f_pref, g_pref_inv, row_quot = (torch.stack([o[i] for o in outs]) for i in range(3))
    return (f_pref.reshape(K, C, nch, n), g_pref_inv.reshape(K, C, nch - 1, n),
            row_quot.reshape(K, C, n))


def _finish(f_pref, g_pref_inv, row_quot):
    """The plain version's tail: running product over the row axis, Z and the
    partial products -> (z [K, C, n], pp [K, C, nch-1, n], wrap [K, C])."""
    cum = _cumprod(row_quot)
    z = torch.cat([torch.ones_like(cum[..., :1]), cum[..., :-1]], dim=-1)
    # nch == 1 (R <= CHUNK): both factors are empty and so is pp
    pp = gl.mul(z[:, :, None, :], gl.mul(f_pref[:, :, :-1], g_pref_inv))
    return z, pp, cum[..., -1]


def perm_columns_plain(wires, betas, gammas, id_vals, sigma):
    """Plain PyTorch version of ``perm_columns_cuda``, on whatever device."""
    return _finish(*stage1_plain(wires, betas, gammas, id_vals, sigma))


def perm_columns_cuda(wires, betas, gammas, id_vals, sigma):
    """wires [K, >= R, n] (the first R rows are read), betas, gammas [K, C],
    id_vals, sigma [R, n] -> (z [K, C, n], pp [K, C, nch-1, n], wrap [K, C]),
    int64 bit patterns of canonical field elements; ``wires`` may be a view
    with any row and proof strides (its last axis contiguous).  CUDA tensors:
    ``LAUNCHES_PER_CALL`` launches per 65,535 proofs (or an exception).  CPU
    tensors: the plain version."""
    name = "perm_columns_cuda"
    cb.require_field(name, wires=wires, betas=betas, gammas=gammas, id_vals=id_vals, sigma=sigma)
    if wires.dim() != 3 or betas.dim() != 2 or id_vals.dim() != 2:
        raise ValueError(
            f"{name} wants wires [K, >= R, n], betas [K, C], id_vals [R, n], got "
            f"{tuple(wires.shape)}, {tuple(betas.shape)}, {tuple(id_vals.shape)}"
        )
    K, rows, n = wires.shape
    C = betas.shape[1]
    R = id_vals.shape[0]
    nch = n_chunks(R)
    if not 1 <= R <= rows or betas.shape[0] != K or gammas.shape != betas.shape:
        raise ValueError(
            f"{name} wants 1 <= R <= {rows} and betas, gammas [{K}, C], got R = {R}, "
            f"{tuple(betas.shape)}, {tuple(gammas.shape)}"
        )
    if tuple(id_vals.shape) != (R, n) or tuple(sigma.shape) != (R, n):
        raise ValueError(
            f"{name} wants id_vals and sigma [{R}, {n}], got {tuple(id_vals.shape)} "
            f"and {tuple(sigma.shape)}"
        )
    cb.require_same_device(name, wires, betas=betas, gammas=gammas, id_vals=id_vals, sigma=sigma)
    if not wires.is_cuda:
        return perm_columns_plain(wires, betas, gammas, id_vals, sigma)
    cb.require_contiguous(name, betas=betas, gammas=gammas, id_vals=id_vals, sigma=sigma)
    if n > 1 and wires.stride(2) != 1:
        raise ValueError(f"{name} wants the last axis of wires contiguous")
    if K * C * n == 0:
        raise ValueError(f"{name} wants at least one proof, challenge and point, got {(K, C, n)}")
    if K > cb.MAX_GRID_YZ:  # proofs ride on the grid's second and third axes
        parts = [perm_columns_cuda(wires[a:b], betas[a:b], gammas[a:b], id_vals, sigma)
                 for a, b in cb.grid_chunks(K)]
        return tuple(torch.cat([p[i] for p in parts]) for i in range(3))
    dev = wires.device
    z = torch.empty((K, C, n), dtype=torch.int64, device=dev)
    pp = torch.empty((K, C, nch - 1, n), dtype=torch.int64, device=dev)
    wrap = torch.empty((K, C), dtype=torch.int64, device=dev)
    nb = -(-n // cb.load().perm_columns_row_block())  # blocks of points; the product is carried between them
    totals = torch.empty((K, C, nb), dtype=torch.int64, device=dev)  # block products, then carries
    g_mid = torch.empty((K, C, max(nch - 2, 0), n), dtype=torch.int64, device=dev)  # pass A's scratch
    cb.launch(name, "perm_columns_rows", dev,
              wires.data_ptr(), wires.stride(0), wires.stride(1), id_vals.data_ptr(),
              sigma.data_ptr(), betas.data_ptr(), gammas.data_ptr(), z.data_ptr(), pp.data_ptr(),
              g_mid.data_ptr(), totals.data_ptr(), K, C, R, nch, n, nb)
    cb.launch(name, "perm_columns_carries", dev, totals.data_ptr(), wrap.data_ptr(), K, C, nb)
    cb.launch(name, "perm_columns_finish", dev, z.data_ptr(), pp.data_ptr(), totals.data_ptr(),
              K, C, nch, n, nb)
    return z, pp, wrap
