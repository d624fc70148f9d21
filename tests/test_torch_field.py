"""Port vs JAX package: Goldilocks base field and quadratic extension.

Same numpy-seeded inputs through both; every comparison is ``==`` on the
u64 values (the arithmetic is exact mod p: tolerance 0)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from intmax_zkp_core_tpu.ops import goldilocks as jgl
from intmax_zkp_core_tpu_torch.ops import goldilocks as tgl

torch.set_num_threads(1)

P = 0xFFFFFFFF00000001
EDGES = [0, 1, P - 1, (1 << 32) - 1, 1 << 32, 1 << 63, (1 << 64) - 1, P, P + 1]


def _t(a):
    return tgl.from_u64(a, "cpu")


def _pairs(seed, n, canonical):
    rng = np.random.default_rng(seed)
    hi = P if canonical else 1 << 64
    edges = [e for e in EDGES if e < hi]
    a = rng.integers(0, hi, size=n, dtype=np.uint64)
    b = rng.integers(0, hi, size=n, dtype=np.uint64)
    grid = np.array([(x, y) for x in edges for y in edges], dtype=np.uint64)
    return np.concatenate([grid[:, 0], a]), np.concatenate([grid[:, 1], b])


@pytest.mark.parametrize("op", ["add", "sub", "mul"])
@pytest.mark.parametrize("canonical", [True, False])
def test_binary_ops_match(op, canonical):
    # non-canonical inputs too: the JAX functions accept any u64 bit pattern
    a, b = _pairs(1, 1 << 16, canonical)
    want = np.asarray(getattr(jgl, op)(jnp.asarray(a), jnp.asarray(b)))
    got = tgl.to_u64(getattr(tgl, op)(_t(a), _t(b)))
    assert (got == want).all()
    if canonical and op == "mul":
        exact = [(int(x) * int(y)) % P for x, y in zip(a[:200], b[:200])]
        assert [int(v) for v in got[:200]] == exact


@pytest.mark.parametrize("op", ["neg", "square", "inv", "canonicalize"])
def test_unary_ops_match(op):
    a, _ = _pairs(2, 4096, op != "canonicalize")
    want = np.asarray(getattr(jgl, op)(jnp.asarray(a)))
    got = tgl.to_u64(getattr(tgl, op)(_t(a)))
    assert (got == want).all()


def test_mul_small_pow_const_reduce128_match():
    a, b = _pairs(3, 4096, True)
    for c in (1, 7, 41, (1 << 20) - 1):
        assert (tgl.to_u64(tgl.mul_small(_t(a), c)) == np.asarray(jgl.mul_small(jnp.asarray(a), c))).all()
    for e in (0, 1, 7, 65537):
        assert (tgl.to_u64(tgl.pow_const(_t(a), e)) == np.asarray(jgl.pow_const(jnp.asarray(a), e))).all()
    hi, lo = _pairs(4, 4096, False)
    assert (tgl.to_u64(tgl.reduce128(_t(hi), _t(lo))) == np.asarray(jgl.reduce128(jnp.asarray(hi), jnp.asarray(lo)))).all()


def test_scalar_operand_and_powers():
    a, _ = _pairs(5, 1000, True)
    c = 0xFFFFFFFF00000000  # p - 1: a bit pattern above 2^63
    assert (tgl.to_u64(tgl.mul(_t(a), tgl.i64(c))) == np.asarray(jgl.mul(jnp.asarray(a), jnp.uint64(c)))).all()
    assert (tgl.to_u64(tgl.add(_t(a), tgl.i64(c))) == np.asarray(jgl.add(jnp.asarray(a), jnp.uint64(c)))).all()
    w = tgl.primitive_root_of_unity(10)
    assert w == jgl.primitive_root_of_unity(10)
    pw = tgl.to_u64(tgl.powers(w, 1000, "cpu"))
    assert [int(v) for v in pw] == [pow(w, i, P) for i in range(1000)]


@pytest.mark.parametrize("op", ["ext_mul", "ext_add", "ext_sub"])
def test_ext_binary_match(op):
    rng = np.random.default_rng(6)
    a = rng.integers(0, P, size=(4096, 2), dtype=np.uint64)
    b = rng.integers(0, P, size=(4096, 2), dtype=np.uint64)
    a[0], b[0], a[1], b[1] = 0, P - 1, P - 1, P - 1
    want = np.asarray(getattr(jgl, op)(jnp.asarray(a), jnp.asarray(b)))
    assert (tgl.to_u64(getattr(tgl, op)(_t(a), _t(b))) == want).all()


def test_ext_inv_pow_match():
    rng = np.random.default_rng(7)
    a = rng.integers(0, P, size=(512, 2), dtype=np.uint64)
    assert (tgl.to_u64(tgl.ext_inv(_t(a))) == np.asarray(jgl.ext_inv(jnp.asarray(a)))).all()
    assert (tgl.to_u64(tgl.ext_pow_const(_t(a), 11)) == np.asarray(jgl.ext_pow_const(jnp.asarray(a), 11))).all()
    one = tgl.to_u64(tgl.ext_mul(_t(a), tgl.ext_inv(_t(a))))
    assert (one[:, 0] == 1).all() and (one[:, 1] == 0).all()


def test_device_none_raises_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError):
        tgl.resolve_device(None)
    with pytest.raises(RuntimeError):
        tgl.as_field(np.zeros(4, dtype=np.uint64))
