"""The Poseidon gate's share of the quotient, as a hand-written CUDA kernel
with its plain PyTorch version.

Per proof k, challenge c and LDE point x, with t_0 .. t_122 the constraints
of ``engine/gates.py::PoseidonGate`` in its order:

    acc'[k, c] = acc[k, c] + sel * sum_j apows[k, c] * alphas[k, c]^j * t_j
    apows'[k, c] = apows[k, c] * alphas[k, c]^123

``poseidon_gate_quotient_cuda(wires_lde [K, W, L], sel_col [L], alphas [K, C],
acc [K, C, L], apows [K, C])`` -> ``(acc' [K, C, L], apows' [K, C])``.
Replaces the JAX package's ``ops/gate_quotient_pallas.py::
poseidon_gate_quotient_pallas`` and its ``_batched`` form (K = 1 is the
single-proof form).  The kernel (``csrc/gate_quotient.cu``) runs one thread
per (proof, point): all 123 constraints on loose values, each folded into
the C sums as soon as it exists, every sum (the C folds, each table row)
kept unreduced and reduced once.  Its sums are registers, so a launch takes
at most ``MAX_C`` challenges: more go over one launch per group
(``challenge_groups``), as more than 65,535 proofs, the grid's second axis,
go over one launch per chunk.  Its constants (round constants, MDS, the
gate's wire layout and the affine tables ``PARTIAL_A`` / ``PARTIAL_B`` as
dense rows) are uploaded once from the port's own Python constants.

The plain version is ``poseidon_gate_quotient_plain``:
``PoseidonGate.eval_constraints_batched`` and the per-constraint fold of the
prover.  The wrapper takes it only for tensors on the CPU; for CUDA tensors
it launches the kernel or raises.
"""

from __future__ import annotations

import ctypes

import torch

from ..engine.gates import GATE_TYPES, PoseidonGate
from . import cuda_build as cb
from . import goldilocks as gl
from .poseidon_constants import (
    ALL_ROUND_CONSTANTS,
    MDS_MATRIX_CIRC,
    MDS_MATRIX_DIAG,
    N_PARTIAL_ROUNDS,
    SPONGE_WIDTH,
)
from .poseidon_fast import PARTIAL_A, PARTIAL_B

GATE = GATE_TYPES["poseidon"]
N_CS = GATE.num_constraints
# challenges one launch takes (the kernel's running sums are registers)
MAX_C = 4
_LAYOUT = ("W_IN", "W_OUT", "W_SWAP", "W_DELTA", "W_FULL1", "W_PARTIAL", "W_S26", "W_FULL2")

_constants_on: set = set()  # device indices whose __constant__ tables are filled


def affine_tables():
    """The rows of ``PARTIAL_A`` then ``PARTIAL_B`` as the kernel stores them:
    (constant terms [34], coefficients [34][34]) over the basis
    [Y_0..Y_11, x_0..x_21], dense.  Row i of ``PARTIAL_A`` reads x_j for
    j < i only, so its coefficients beyond 12 + i are zero, as
    ``eval_constraints_batched`` reads them."""
    T, P = SPONGE_WIDTH, gl.P_INT
    basis = T + N_PARTIAL_ROUNDS
    consts, coef = [], []
    rows = [(row, i) for i, row in enumerate(PARTIAL_A)] + [(row, N_PARTIAL_ROUNDS) for row in PARTIAL_B]
    for row, n_x in rows:
        consts.append(row[0] % P)
        coef.append([row[1 + j] % P for j in range(T + n_x)] + [0] * (basis - T - n_x))
    return consts, coef


def set_constants(lib) -> int:
    """Fill the ``__constant__`` tables of ``lib``'s gate kernel on the
    current device: the round constants and MDS entries, the gate's wire
    layout and ``affine_tables``.  Returns the code of
    ``gate_quotient_set_constants``."""
    if (N_CS, SPONGE_WIDTH, N_PARTIAL_ROUNDS, len(ALL_ROUND_CONSTANTS)) != (123, 12, 22, 360):
        raise RuntimeError("gate_quotient.cu is written for the 123-constraint Poseidon-12 gate")
    if any(MDS_MATRIX_DIAG[1:]):
        raise RuntimeError("gate_quotient.cu assumes a single diagonal MDS entry")
    consts, coef = affine_tables()

    def u64s(values):
        return (ctypes.c_ulonglong * len(values))(*values)

    layout = (ctypes.c_longlong * len(_LAYOUT))(*[getattr(PoseidonGate, name) for name in _LAYOUT])
    return lib.gate_quotient_set_constants(
        u64s(ALL_ROUND_CONSTANTS), u64s(MDS_MATRIX_CIRC), MDS_MATRIX_DIAG[0], layout, u64s(consts),
        u64s([c for row in coef for c in row]))


def _ready(device: torch.device) -> None:
    """Library loaded and the kernel's ``__constant__`` tables filled on ``device``."""
    lib = cb.load()
    index = device.index if device.index is not None else torch.cuda.current_device()
    if index not in _constants_on:
        with torch.cuda.device(index):
            code = set_constants(lib)
        cb.check(code, "gate_quotient_set_constants")
        _constants_on.add(index)


def poseidon_gate_quotient_plain(wires_lde, sel_col, alphas, acc, apows):
    """Plain PyTorch version of ``poseidon_gate_quotient_cuda``, on whatever
    device: the gate's constraints by ``eval_constraints_batched``, folded one
    by one (``acc += apow * (sel * t); apow *= alpha``)."""
    K, C, L = acc.shape
    accs, pows = [], []
    for k in range(K):
        cs = GATE.eval_constraints_batched(
            [wires_lde[k, i] for i in range(GATE.NUM_WIRES_USED)], [], None)
        out_acc = [acc[k, c] for c in range(C)]
        out_apows = [apows[k, c] for c in range(C)]
        for t in cs:
            filt = gl.mul(sel_col, t)
            for c in range(C):
                out_acc[c] = gl.add(out_acc[c], gl.mul(out_apows[c], filt))
                out_apows[c] = gl.mul(out_apows[c], alphas[k, c])
        accs.append(torch.stack(out_acc))
        pows.append(torch.stack(out_apows))
    return torch.stack(accs), torch.stack(pows)


def challenge_groups(fn, wires_lde, sel_col, alphas, acc, apows):
    """``fn`` (this module's wrapper or plain version) over the challenges in
    groups of at most ``MAX_C``, the groups' results joined: each
    challenge's sum and power of alpha are its own, so no value passes
    between the groups."""
    C = acc.shape[1]
    parts = [fn(wires_lde, sel_col, alphas[:, a:b].contiguous(), acc[:, a:b].contiguous(),
                apows[:, a:b].contiguous())
             for a, b in ((a, min(a + MAX_C, C)) for a in range(0, C, MAX_C))]
    return torch.cat([p[0] for p in parts], dim=1), torch.cat([p[1] for p in parts], dim=1)


def poseidon_gate_quotient_cuda(wires_lde, sel_col, alphas, acc, apows):
    """wires_lde [K, W >= 135, L] (any row and proof strides, last axis
    contiguous), sel_col [L], alphas [K, C], acc [K, C, L], apows [K, C]; int64
    bit patterns.  CUDA tensors: one launch per group of at most ``MAX_C``
    challenges and 65,535 proofs (or an exception).  CPU tensors: the plain
    version."""
    name = "poseidon_gate_quotient_cuda"
    tensors = {"sel_col": sel_col, "alphas": alphas, "acc": acc, "apows": apows}
    cb.require_field(name, wires_lde=wires_lde, **tensors)
    if acc.dim() != 3:
        raise ValueError(f"{name} wants acc [K, C, L], got {tuple(acc.shape)}")
    K, C, L = acc.shape
    want = {"sel_col": (L,), "alphas": (K, C), "apows": (K, C)}
    for arg, shape in want.items():
        if tuple(tensors[arg].shape) != shape:
            raise ValueError(f"{name} wants {arg} {list(shape)}, got {tuple(tensors[arg].shape)}")
    W = GATE.NUM_WIRES_USED
    if (wires_lde.dim() != 3 or wires_lde.shape[0] != K or wires_lde.shape[1] < W
            or wires_lde.shape[2] != L):
        raise ValueError(f"{name} wants wires_lde [{K}, >= {W}, {L}], got {tuple(wires_lde.shape)}")
    cb.require_same_device(name, wires_lde, **tensors)
    if not wires_lde.is_cuda:
        return poseidon_gate_quotient_plain(wires_lde, sel_col, alphas, acc, apows)
    cb.require_contiguous(name, **tensors)
    if L > 1 and wires_lde.stride(2) != 1:
        raise ValueError(f"{name} wants the last axis of wires_lde contiguous")
    if K < 1 or C < 1 or L < 1:
        raise ValueError(f"{name} takes K >= 1, C >= 1 and L >= 1, got {(K, C, L)}")
    if C > MAX_C:
        return challenge_groups(poseidon_gate_quotient_cuda, wires_lde, sel_col, alphas, acc, apows)
    if K > cb.MAX_GRID_YZ:  # proofs ride on the grid's second axis
        parts = [poseidon_gate_quotient_cuda(wires_lde[a:b], sel_col, alphas[a:b], acc[a:b],
                                             apows[a:b]) for a, b in cb.grid_chunks(K)]
        return torch.cat([p[0] for p in parts]), torch.cat([p[1] for p in parts])
    _ready(acc.device)
    out = torch.empty_like(acc)
    apows_out = torch.empty_like(apows)
    cb.launch(name, "gate_quotient", acc.device,
              wires_lde.data_ptr(), wires_lde.stride(0), wires_lde.stride(1), sel_col.data_ptr(),
              alphas.data_ptr(), acc.data_ptr(), apows.data_ptr(), out.data_ptr(),
              apows_out.data_ptr(), K, C, L)
    return out, apows_out
