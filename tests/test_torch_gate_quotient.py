"""K4, the Poseidon gate's share of the quotient: the port's plain version
against the JAX package's quotient chunk and against the gate's scalar
constraints.

Same inputs from a numpy seed through the JAX package's
``engine/prover.py::_gate_quotient_chunk("poseidon", 0, 123, ...,
use_jit=False)`` (the eager path the Pallas kernel is held against there) and
through ``poseidon_gate_quotient_cuda`` of the port (on the CPU the wrapper
takes the plain version).  Tolerance 0."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from intmax_zkp_core_tpu.engine.prover import _gate_quotient_chunk as j_gate_quotient_chunk
from intmax_zkp_core_tpu_torch.engine.algebra import ExtAlgebra
from intmax_zkp_core_tpu_torch.engine.gates import PoseidonGate
from intmax_zkp_core_tpu_torch.ops import gate_quotient_cuda as gqc
from intmax_zkp_core_tpu_torch.ops import goldilocks as gl
from intmax_zkp_core_tpu_torch.ops.poseidon_fast import PARTIAL_A, PARTIAL_B

torch.set_num_threads(1)

P = gl.P_INT
W, N_CONST, C, L = 135, 16, 2, 64


def _field(rng, shape):
    a = rng.integers(0, P, size=shape, dtype=np.uint64)
    a.reshape(-1)[::7] = 0  # lanes of 0 and p-1
    a.reshape(-1)[3::11] = P - 1
    return a


@pytest.fixture(scope="module")
def proofs():
    """Three proofs' inputs (seed 23) and, per proof, the JAX package's
    (acc', apows'), computed once."""
    rng = np.random.default_rng(23)
    data = {
        "wires": _field(rng, (3, W, L)), "sel": _field(rng, (L,)),
        "const_cols": _field(rng, (N_CONST, L)), "pi_hash": _field(rng, (4,)),
        "alphas": _field(rng, (3, C)), "acc": _field(rng, (3, C, L)), "apows": _field(rng, (3, C)),
    }
    run = j_gate_quotient_chunk("poseidon", 0, gqc.N_CS, W, N_CONST, C, use_jit=False)
    data["jax"] = [
        [np.asarray(v) for v in run(*(jnp.asarray(a) for a in (
            data["wires"][k], data["sel"], data["const_cols"], data["pi_hash"],
            data["alphas"][k], data["acc"][k], data["apows"][k])))]
        for k in range(3)
    ]
    return data


@pytest.mark.parametrize("K", [1, 3])
def test_plain_equals_jax_gate_quotient_chunk(proofs, K):
    t = {name: gl.from_u64(proofs[name][:K], "cpu") for name in ("wires", "alphas", "acc", "apows")}
    sel = gl.from_u64(proofs["sel"], "cpu")
    before = gqc.cb.launch_counts()
    acc, apows = gqc.poseidon_gate_quotient_cuda(t["wires"], sel, t["alphas"], t["acc"], t["apows"])
    assert gqc.cb.launch_counts() == before  # a CPU tensor launches nothing
    assert acc.shape == (K, C, L) and apows.shape == (K, C)
    for k in range(K):
        want_acc, want_apows = proofs["jax"][k]
        assert np.array_equal(gl.to_u64(acc[k]), want_acc)
        assert np.array_equal(gl.to_u64(apows[k]), want_apows)


def _valid_row(rng):
    vals = PoseidonGate.fill_row([int(v) for v in rng.integers(0, P, 12, dtype=np.uint64)], 1)
    return [vals[i] for i in range(W)]


def test_plain_constraints_equal_the_scalar_gate_point_by_point():
    # the constraints the plain version folds (eval_constraints_batched) against
    # PoseidonGate.eval_constraints through the verifier's algebra, constraint by
    # constraint, on random points and on a valid row (all zero there)
    rng = np.random.default_rng(24)
    wires = _field(rng, (W, 6))
    wires[:, 5] = _valid_row(rng)
    cs = gqc.GATE.eval_constraints_batched(
        [gl.from_u64(wires[i], "cpu") for i in range(W)], [], None)
    assert len(cs) == gqc.N_CS
    got = np.stack([gl.to_u64(c) for c in cs])  # [123, points]
    alg = ExtAlgebra()
    for x in range(wires.shape[1]):
        want = gqc.GATE.eval_constraints(alg, [(int(v), 0) for v in wires[:, x]], [], None)
        assert [c1 for _, c1 in want] == [0] * gqc.N_CS
        assert [int(v) for v in got[:, x]] == [c0 for c0, _ in want]
    assert not got[:, 5].any()


def test_plain_fold_equals_python_ints():
    # acc' = acc + sel * sum_j apows * alpha^j * t_j and apows' = apows * alpha^123,
    # with t_j from the scalar gate, on a few points
    rng = np.random.default_rng(25)
    wires, sel = _field(rng, (1, W, 4)), _field(rng, (4,))
    alphas, acc, apows = _field(rng, (1, C)), _field(rng, (1, C, 4)), _field(rng, (1, C))
    got_acc, got_apows = (gl.to_u64(v) for v in gqc.poseidon_gate_quotient_plain(
        *(gl.from_u64(a, "cpu") for a in (wires, sel, alphas, acc, apows))))
    alg = ExtAlgebra()
    for x in range(4):
        ts = [c0 for c0, _ in gqc.GATE.eval_constraints(alg, [(int(v), 0) for v in wires[0, :, x]], [], None)]
        for c in range(C):
            a, apow = int(alphas[0, c]), int(apows[0, c])
            total = sum(apow * pow(a, j, P) * t for j, t in enumerate(ts)) % P
            assert int(got_acc[0, c, x]) == (int(acc[0, c, x]) + int(sel[x]) * total) % P
            assert int(got_apows[0, c]) == apow * pow(a, gqc.N_CS, P) % P


def test_affine_tables_hold_every_nonzero_coefficient():
    # the dense rows the kernel's constants are made of rebuild PARTIAL_A
    # (x_j for j < i, zero beyond) and PARTIAL_B
    consts, coef = gqc.affine_tables()
    rows = list(PARTIAL_A) + list(PARTIAL_B)
    assert len(consts) == len(coef) == len(rows) == 34 and all(len(r) == 34 for r in coef)
    for r, row in enumerate(rows):
        n_x = r if r < 22 else 22
        assert consts[r] == row[0] % P
        assert coef[r][: 12 + n_x] == [v % P for v in row[1 : 13 + n_x]]
        assert not any(coef[r][12 + n_x :])
    assert all(0 <= c < P for r in coef for c in r)
    assert sum(1 for r in coef for c in r if c) == 903


# The kernel's order (csrc/gate_quotient.cu) in Python ints: its loose
# arithmetic (goldilocks.cuh, every value asserted below 2^64), one
# unreduced sum per table row and per challenge's fold, reduced once.
M64, EPS = (1 << 64) - 1, (1 << 32) - 1


def _reduce128(x):  # gl_reduce128_loose
    assert 0 <= x < 1 << 128
    lo, hi_lo, hi_hi = x & M64, (x >> 64) & EPS, x >> 96
    k, r = divmod(lo + (hi_lo << 32) - hi_lo - hi_hi, 1 << 64)
    assert k in (-1, 0, 1)
    r += k * EPS
    assert 0 <= r <= M64 and r % P == x % P
    return r


def _reduce_dot(terms):  # GlDot::mac over the terms, hi_lo, gl_reduce160_loose
    total = 0
    for a, b in terms:
        assert 0 <= a <= M64 and 0 <= b <= M64
        total += a * b
    assert total >> 128 < 1 << 32
    r, t = _reduce128(total & ((1 << 128) - 1)), (total >> 128) << 32
    d = (r - t) & M64
    if r < t:
        d -= EPS
    assert 0 <= d <= M64 and d % P == total % P
    return d


def _add(a, c):  # gl_add_loose: a loose, c canonical
    assert c < P
    s = a + c
    if s > M64:
        s = (s & M64) + EPS
    assert s <= M64
    return s


def _sub(a, c):  # gl_sub_loose: a loose, c canonical
    assert c < P and a <= M64
    d = a - c
    if d < 0:
        d += (1 << 64) - EPS
    assert 0 <= d <= M64
    return d


def _canon(x):  # gl_canon
    return x - P if x >= P else x


def _sbox(x):  # gl_sbox7_loose
    x3 = _reduce128(_reduce128(x * x) * x)
    return _reduce128(_reduce128(x3 * x3) * x)


def _full_round(s, rnd):  # gate_quotient.cu::full_round_loose
    from intmax_zkp_core_tpu_torch.ops.poseidon_constants import (
        ALL_ROUND_CONSTANTS, MDS_MATRIX_CIRC, MDS_MATRIX_DIAG)

    v = [_sbox(_add(x, ALL_ROUND_CONSTANTS[rnd * 12 + i])) for i, x in enumerate(s)]
    out = []
    for r in range(12):
        acc_lo = sum(MDS_MATRIX_CIRC[i] * (v[(r + i) % 12] & EPS) for i in range(12))
        acc_hi = sum(MDS_MATRIX_CIRC[i] * (v[(r + i) % 12] >> 32) for i in range(12))
        if r == 0:
            acc_lo += MDS_MATRIX_DIAG[0] * (v[0] & EPS)
            acc_hi += MDS_MATRIX_DIAG[0] * (v[0] >> 32)
        assert acc_lo < 1 << 41 and acc_hi < 1 << 41
        n2, n = divmod(acc_lo + (acc_hi << 32), 1 << 64)  # gl_fold_reduce_loose
        k, x = divmod(n + (n2 << 32) - n2, 1 << 64)
        assert k in (0, 1)
        x += k * EPS
        assert x <= M64
        out.append(x)
    return out


def _replay_point(col, sel, alphas, acc, apows):
    """gate_quotient_kernel<C> at one point: the wires ``col`` [135] and the
    proof's C challenges; returns (acc' [C], apows' [C])."""
    from intmax_zkp_core_tpu_torch.ops.poseidon_constants import ALL_ROUND_CONSTANTS

    consts, coef = gqc.affine_tables()
    g = PoseidonGate
    tbl = []
    for a, p0 in zip(alphas, apows):  # one entry per thread, square-and-multiply
        row = []
        for j in range(gqc.N_CS + 1):
            p, base, bits = p0, a, j
            while bits:
                if bits & 1:
                    p = p * base % P
                base = base * base % P
                bits >>= 1
            row.append(p)
        tbl.append(row)
    ts = []
    swap = col[g.W_SWAP]
    ts.append((swap * swap - swap) % P)
    s = [0] * 12
    for i in range(4):
        lo, hi, delta = col[g.W_IN + i], col[g.W_IN + 4 + i], col[g.W_DELTA + i]
        ts.append((delta - swap * (hi - lo)) % P)
        s[i], s[4 + i] = (lo + delta) % P, (hi - delta) % P
    s[8:] = col[g.W_IN + 8 : g.W_IN + 12]

    def against(s, base):
        for i in range(12):
            ts.append(_sub(col[base + i], _canon(s[i])))
        return list(col[base : base + 12])

    for r in range(3):
        s = against(_full_round(s, r), g.W_FULL1 + 12 * r)
    y = [_sbox(_add(v, ALL_ROUND_CONSTANTS[36 + i])) for i, v in enumerate(s)]
    x = []

    def table_row(r, n_x):
        terms = list(zip(y, coef[r][:12])) + list(zip(x[:n_x], coef[r][12 : 12 + n_x]))
        return _add(_reduce_dot(terms), consts[r])

    for r in range(22):
        b = col[g.W_PARTIAL + r]
        ts.append(_sub(b, _canon(table_row(r, r))))
        x.append(_sbox(b))
    for lane in range(12):
        ts.append(_sub(col[g.W_S26 + lane], _canon(table_row(22 + lane, 22))))
    s = list(col[g.W_S26 : g.W_S26 + 12])
    for r in range(4):
        s = against(_full_round(s, 26 + r), g.W_FULL2 + 12 * r if r < 3 else g.W_OUT)
    assert len(ts) == gqc.N_CS
    out = [(a + _reduce_dot(zip(tbl[c], ts)) * sel) % P for c, a in enumerate(acc)]
    return out, [row[gqc.N_CS] for row in tbl]


@pytest.mark.parametrize("C", [1, 2, 4])
def test_kernel_order_replayed_in_python_ints(C):
    """The kernel's order at a few points (two valid rows, where every
    constraint is 0, and three random ones): the table rows and the C folds
    as single unreduced sums, loose Poseidon rounds, every intermediate
    below 2^64, equal the plain version."""
    rng = np.random.default_rng(26 + C)
    wires, sel = _field(rng, (1, W, 5)), _field(rng, (5,))
    wires[0, :, 0] = _valid_row(rng)
    wires[0, :, 3] = _valid_row(rng)
    alphas, acc, apows = _field(rng, (1, C)), _field(rng, (1, C, 5)), _field(rng, (1, C))
    want_acc, want_apows = (gl.to_u64(v) for v in gqc.poseidon_gate_quotient_plain(
        *(gl.from_u64(a, "cpu") for a in (wires, sel, alphas, acc, apows))))
    for t in range(5):
        got_acc, got_apows = _replay_point(
            [int(v) for v in wires[0, :, t]], int(sel[t]), [int(v) for v in alphas[0]],
            [int(v) for v in acc[0, :, t]], [int(v) for v in apows[0]])
        assert got_acc == [int(v) for v in want_acc[0, :, t]]
        assert got_apows == [int(v) for v in want_apows[0]]


def test_wrapper_rejects_bad_arguments():
    args = [torch.zeros((1, W, 8), dtype=torch.int64), torch.zeros(8, dtype=torch.int64),
            torch.zeros((1, C), dtype=torch.int64), torch.zeros((1, C, 8), dtype=torch.int64),
            torch.zeros((1, C), dtype=torch.int64)]
    with pytest.raises(ValueError):
        gqc.poseidon_gate_quotient_cuda(args[0][:, :100], *args[1:])  # fewer than 135 wire rows
    with pytest.raises(ValueError):
        gqc.poseidon_gate_quotient_cuda(args[0], torch.zeros(9, dtype=torch.int64), *args[2:])
    with pytest.raises(TypeError):
        gqc.poseidon_gate_quotient_cuda(args[0].int(), *args[1:])
