"""The permutation-argument terms of the quotient, as a hand-written CUDA
kernel with its plain PyTorch version.

Per LDE point x and challenge, alpha-combined in the verifier's order:

    L_0(x) * (Z(x) - 1)  and, per chunk j of 7 routed wires,
    next_j * g_j - prev_j * f_j,
    f_i = w_i + (beta * k_i) * x + gamma,   g_i = w_i + beta * sigma_i + gamma,

with prev/next running through Z, the partial products and Z(x * omega).

``perm_quotient_cuda(wires_lde, zs_lde, pps_lde, betas, gammas, alphas,
sigma_lde, xs, l0, k_is, blowup)`` -> ``(acc [K, C, L], apows [K, C])``.
Replaces the JAX package's
``ops/perm_quotient_pallas.py::perm_quotient_pallas_batched``.  The kernel
(``csrc/perm_quotient.cu``) runs one thread per (proof, point) and all
challenges (for C <= 4; one challenge per thread for any other C), so each
wire and sigma value is loaded once; each block makes the small tables (the
alpha powers, the ``beta * k_i``) for itself, and each challenge's ``acc =
sum_k alpha^k * term_k`` is one unreduced sum of products, reduced once,
which equals the plain version's left fold because the arithmetic is exact.

The plain version is ``perm_quotient_plain``.  The wrapper takes it only for
tensors on the CPU; for CUDA tensors it launches the kernel or raises.
"""

from __future__ import annotations

import torch

from . import cuda_build as cb
from . import goldilocks as gl

# wires per partial product (keeps the constraint degree at 8)
CHUNK = 7


def n_chunks(num_routed: int) -> int:
    return (num_routed + CHUNK - 1) // CHUNK


def perm_quotient_plain(wires_lde, zs_lde, pps_lde, betas, gammas, alphas,
                        sigma_lde, xs, l0, k_is, blowup: int):
    """Plain PyTorch version of ``perm_quotient_cuda``, on whatever device:
    wires_lde [K, >= R, L] (the first R rows are read), zs_lde [K, C, L],
    pps_lde [K, C, nch-1, L], betas, gammas, alphas [K, C], sigma_lde [R, L],
    xs, l0 [L], k_is [R] -> (acc [K, C, L], apows [K, C] = alpha^(nch+1))."""
    K, C, L = zs_lde.shape
    R = sigma_lde.shape[0]
    nch = n_chunks(R)
    accs, apows = [], []
    for k in range(K):
        for c in range(C):
            beta, gamma, alpha = betas[k, c], gammas[k, c], alphas[k, c]
            Z = zs_lde[k, c]
            Z_shift = torch.roll(Z, -blowup)
            terms = [gl.mul(l0, gl.sub(Z, 1))]
            prev = Z
            for j in range(nch):
                lo, hi = j * CHUNK, min((j + 1) * CHUNK, R)
                f = None
                g_ = None
                for i in range(lo, hi):
                    v = wires_lde[k, i]
                    fid = gl.add(gl.add(v, gl.mul(gl.mul(beta, k_is[i]), xs)), gamma)
                    gs = gl.add(gl.add(v, gl.mul(beta, sigma_lde[i])), gamma)
                    f = fid if f is None else gl.mul(f, fid)
                    g_ = gs if g_ is None else gl.mul(g_, gs)
                nxt = Z_shift if j == nch - 1 else pps_lde[k, c, j]
                terms.append(gl.sub(gl.mul(nxt, g_), gl.mul(prev, f)))
                if j < nch - 1:
                    prev = pps_lde[k, c, j]
            acc = torch.zeros(L, dtype=torch.int64, device=zs_lde.device)
            apow = torch.ones((), dtype=torch.int64, device=zs_lde.device)
            for t in terms:
                acc = gl.add(acc, gl.mul(apow, t))
                apow = gl.mul(apow, alpha)
            accs.append(acc)
            apows.append(apow)
    return torch.stack(accs).reshape(K, C, L), torch.stack(apows).reshape(K, C)


def perm_quotient_cuda(wires_lde, zs_lde, pps_lde, betas, gammas, alphas,
                       sigma_lde, xs, l0, k_is, blowup: int):
    """Shapes as ``perm_quotient_plain``, int64 bit patterns of canonical
    field elements.  ``wires_lde``
    may carry more rows than are routed and may be a view with any row and
    proof strides (its last axis contiguous).  CUDA tensors: one launch per
    65,535 proofs (or an exception).  CPU tensors: the plain version."""
    name = "perm_quotient_cuda"
    tensors = {
        "wires_lde": wires_lde, "zs_lde": zs_lde, "pps_lde": pps_lde, "betas": betas,
        "gammas": gammas, "alphas": alphas, "sigma_lde": sigma_lde, "xs": xs, "l0": l0,
        "k_is": k_is,
    }
    cb.require_field(name, **tensors)
    if zs_lde.dim() != 3 or sigma_lde.dim() != 2:
        raise ValueError(
            f"{name} wants zs_lde [K, C, L] and sigma_lde [R, L], got "
            f"{tuple(zs_lde.shape)} and {tuple(sigma_lde.shape)}"
        )
    K, C, L = zs_lde.shape
    R = sigma_lde.shape[0]
    nch = n_chunks(R)
    want = {
        "pps_lde": (K, C, nch - 1, L), "betas": (K, C), "gammas": (K, C), "alphas": (K, C),
        "sigma_lde": (R, L), "xs": (L,), "l0": (L,), "k_is": (R,),
    }
    for arg, shape in want.items():
        if tuple(tensors[arg].shape) != shape:
            raise ValueError(f"{name} wants {arg} {list(shape)}, got {tuple(tensors[arg].shape)}")
    if (wires_lde.dim() != 3 or wires_lde.shape[0] != K or wires_lde.shape[1] < R
            or wires_lde.shape[2] != L or R < 1):
        raise ValueError(
            f"{name} wants wires_lde [{K}, >= {R}, {L}] with R >= 1, got {tuple(wires_lde.shape)}"
        )
    del tensors["wires_lde"]
    cb.require_same_device(name, wires_lde, **tensors)
    if not wires_lde.is_cuda:
        return perm_quotient_plain(wires_lde, zs_lde, pps_lde, betas, gammas, alphas,
                                   sigma_lde, xs, l0, k_is, blowup)
    cb.require_contiguous(name, **tensors)
    if L > 1 and wires_lde.stride(2) != 1:
        raise ValueError(f"{name} wants the last axis of wires_lde contiguous")
    if K * C * L == 0:
        raise ValueError(f"{name} wants at least one proof, challenge and point, got {(K, C, L)}")
    if K > cb.MAX_GRID_YZ:  # proofs ride on the grid's third axis
        parts = [perm_quotient_cuda(wires_lde[a:b], zs_lde[a:b], pps_lde[a:b], betas[a:b],
                                    gammas[a:b], alphas[a:b], sigma_lde, xs, l0, k_is, blowup)
                 for a, b in cb.grid_chunks(K)]
        return torch.cat([p[0] for p in parts]), torch.cat([p[1] for p in parts])
    out = torch.empty((K, C, L), dtype=torch.int64, device=zs_lde.device)
    apows = torch.empty((K, C), dtype=torch.int64, device=zs_lde.device)
    cb.launch(name, "perm_quotient", zs_lde.device,
              wires_lde.data_ptr(), wires_lde.stride(0), wires_lde.stride(1),
              zs_lde.data_ptr(), pps_lde.data_ptr(), sigma_lde.data_ptr(), xs.data_ptr(),
              l0.data_ptr(), betas.data_ptr(), gammas.data_ptr(), alphas.data_ptr(),
              k_is.data_ptr(), out.data_ptr(), apows.data_ptr(), K, C, R, nch, L, blowup)
    return out, apows
