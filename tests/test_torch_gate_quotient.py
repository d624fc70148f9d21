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
    # the (basis index, coefficient) lists the kernel's constants are made of
    # rebuild PARTIAL_A (x_j for j < i) and PARTIAL_B
    consts, starts, index, coef = gqc.affine_tables()
    rows = list(PARTIAL_A) + list(PARTIAL_B)
    assert len(consts) == len(rows) == 34 and len(starts) == 35 and starts[-1] == len(index)
    for r, row in enumerate(rows):
        n_x = r if r < 22 else 22
        dense = [0] * 34
        for e in range(starts[r], starts[r + 1]):
            dense[index[e]] = coef[e]
        assert consts[r] == row[0] % P
        assert dense[: 12 + n_x] == [v % P for v in row[1 : 13 + n_x]]
        assert not any(dense[12 + n_x :])
    assert all(0 < c < P for c in coef) and all(0 <= i < 34 for i in index)


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
