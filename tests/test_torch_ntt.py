"""Port vs JAX package: NTT, inverse NTT, coset LDE and polynomial
evaluation.  Same numpy-seeded inputs through both, ``==`` on u64 values.

``ntt``/``intt`` of the port go through the wrapper of the NTT kernel
(``ops/ntt_cuda.py::ntt_cuda``), which takes the plain version for a tensor on
the CPU; the JAX side runs its XLA NTT and, once each way at 2^14, its Pallas
four-step kernel in interpret mode."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from intmax_zkp_core_tpu.ops import ntt as jnt
from intmax_zkp_core_tpu_torch.ops import goldilocks as tgl
from intmax_zkp_core_tpu_torch.ops import ntt as tnt
from intmax_zkp_core_tpu_torch.ops import ntt_cuda as tnc

torch.set_num_threads(1)

P = 0xFFFFFFFF00000001


def _rand(seed, shape):
    a = np.random.default_rng(seed).integers(0, P, size=shape, dtype=np.uint64)
    a.reshape(-1)[0] = 0
    a.reshape(-1)[-1] = P - 1
    return a


@pytest.mark.parametrize("log_n", range(1, 13))
def test_ntt_intt_match(log_n):
    a = _rand(log_n, (3, 1 << log_n))
    before = tnc.cb.launch_counts()
    fwd = np.asarray(jnt.ntt(jnp.asarray(a)))
    assert (tgl.to_u64(tnt.ntt(a, device="cpu")) == fwd).all()
    inv = np.asarray(jnt.intt(jnp.asarray(a)))
    assert (tgl.to_u64(tnt.intt(a, device="cpu")) == inv).all()
    # round trip on the port's side
    back = tnt.intt(tnt.ntt(tgl.from_u64(a, "cpu")))
    assert (tgl.to_u64(back) == a).all()
    assert tnc.cb.launch_counts() == before  # CPU tensors launch nothing


@pytest.mark.parametrize("inverse", [False, True])
def test_ntt_matches_pallas_four_step_interpret(inverse):
    from intmax_zkp_core_tpu.ops.ntt_pallas import ntt_pallas

    a = _rand(80 + inverse, (1, 1 << 14))
    want = np.asarray(ntt_pallas(jnp.asarray(a), inverse, True))
    got = tnc.ntt_cuda(tgl.from_u64(a, "cpu"), inverse)
    assert (tgl.to_u64(got) == want).all()


def test_fourstep_twiddles_and_launch_plan():
    # the kernel's four-step table w^(i2 * k1) (inverse: w^-(i2 * k1) / n)
    # against exact integers, and one launch up to 2^11, two above
    log_n1, log_n2 = 3, 4
    n = 1 << (log_n1 + log_n2)
    w = tgl.primitive_root_of_unity(log_n1 + log_n2)
    for inverse in (False, True):
        root = pow(w, P - 2, P) if inverse else w
        scale = pow(n, P - 2, P) if inverse else 1
        got = tgl.to_u64(tnc.fourstep_twiddles(log_n1, log_n2, inverse, torch.device("cpu")))
        want = [[scale * pow(root, k1 * i2, P) % P for i2 in range(1 << log_n2)]
                for k1 in range(1 << log_n1)]
        assert got.tolist() == want
    assert [tnc.launches_for(1 << k) for k in (0, 1, 11, 12, 22)] == [1, 1, 1, 2, 2]


# The kernel's schedule (csrc/ntt.cu) in Python ints: its loose arithmetic
# (goldilocks.cuh, every value asserted below 2^64), its register passes,
# index maps and swizzled shared-memory slots, and the wrapper's launch plan
# and tables.
M64, EPS = (1 << 64) - 1, (1 << 32) - 1


def _mul(a, b):  # gl_mul_loose
    x = a * b
    lo, hi_lo, hi_hi = x & M64, (x >> 64) & EPS, x >> 96
    k, r = divmod(lo + (hi_lo << 32) - hi_lo - hi_hi, 1 << 64)
    assert k in (-1, 0, 1)
    r += k * EPS
    assert 0 <= r <= M64 and r % P == x % P
    return r


def _canon(x):  # gl_canon
    return x - P if x >= P else x


def _butterfly(even, odd_times_w):  # ntt.cu::butterfly over gl_add_loose / gl_sub_loose
    t = _canon(odd_times_w)
    s, d = even + t, even - t
    if s > M64:
        s = (s & M64) + EPS
    if d < 0:
        d = d + (1 << 64) - EPS
    assert 0 <= s <= M64 and 0 <= d <= M64
    return s, d


def _dit(y, stages, roots):  # ntt.cu::dit
    w4, w8, w8_3 = roots
    for q in range(stages):
        h = 1 << q
        for t in range(len(y)):
            if t & h:
                continue
            j = t & (h - 1)
            w = 1 if j == 0 else w4 if (q == 1 or j == 2) else w8 if j == 1 else w8_3
            y[t], y[t + h] = _butterfly(y[t], y[t + h] if j == 0 else _mul(y[t + h], w))


def _rev(x, bits):
    return int(format(x, f"0{bits}b")[::-1], 2) if bits else 0


def _swz(a):  # ntt.cu::swz
    return a ^ (((a >> 4) ^ (a >> 8) ^ (a >> 12)) & 15)


def _replay_local(src, dst, M, log_group, n_seq, in_s, out_s, inverse, post=None, scale=None):
    """One launch of ntt_local_kernel<M> over every block, one batch row."""
    tw = [int(v) for v in tgl.to_u64(tnc.root_powers(M, inverse, torch.device("cpu")))]
    roots = tnc.eighth_roots(inverse)
    passes = tnc.passes_for(M)
    rho = min(M, 3)
    log_units = M - rho
    G = 1 << log_group
    n_units = 1 << (log_units + log_group)
    in_rows, out_rows = in_s[1] == 1, out_s[1] == 1

    def write_out(y, u, q):
        for k, v in enumerate(y):
            idx = u + (k << log_units)
            if post is not None:
                v = _mul(v, post[0][idx * post[1] + q])
            if scale is not None:
                v = _mul(v, scale)
            dst[q * out_s[0] + idx * out_s[1]] = _canon(v)

    for seq0 in range(0, n_seq, G):
        sm = {}
        for v in range(n_units):  # pass 1
            u, g = (v & ((1 << log_units) - 1), v >> log_units) if in_rows else (v >> log_group, v & (G - 1))
            q = seq0 + g
            if q >= n_seq:
                continue
            y = [src[q * in_s[0] + (u + (_rev(t, rho) << log_units)) * in_s[1]] for t in range(1 << rho)]
            _dit(y, passes[0], roots)
            if len(passes) == 1:
                write_out(y, u, q)
                continue
            base = (_rev(u, log_units) << 3 << log_group) + g
            for t in range(8):
                slot = _swz(base + (t << log_group))
                assert slot not in sm and slot < G << M
                sm[slot] = y[t]
        s0 = passes[0]
        for _ in passes[1:-1]:  # middle passes
            for v in range(n_units):
                g, cc = v & (G - 1), v >> log_group
                if seq0 + g >= n_seq:
                    continue
                b_lo = cc & ((1 << s0) - 1)
                b = b_lo + ((cc >> s0) << (s0 + 3))
                slots = [_swz(((b + (t << s0)) << log_group) + g) for t in range(8)]
                y = [sm[a] for a in slots]
                y = [y[0]] + [_mul(y[t], tw[(b_lo * _rev(t, 3)) << (M - s0 - 3)]) for t in range(1, 8)]
                _dit(y, 3, roots)
                for a, val in zip(slots, y):
                    sm[a] = val
            s0 += 3
        if len(passes) > 1:  # last pass
            assert s0 == M - 3
            for v in range(n_units):
                u, g = (v & ((1 << log_units) - 1), v >> log_units) if out_rows else (v >> log_group, v & (G - 1))
                q = seq0 + g
                if q >= n_seq:
                    continue
                y = [sm[_swz(((u + (t << log_units)) << log_group) + g)] for t in range(8)]
                y = [y[0]] + [_mul(y[t], tw[u * _rev(t, 3)]) for t in range(1, 8)]
                _dit(y, 3, roots)
                write_out(y, u, q)


def _replay_ntt(rows, inverse, sms):
    """ntt_cuda's launch plan over ``rows`` (lists of ints of one length)."""
    B, n = len(rows), len(rows[0])
    log_n = n.bit_length() - 1
    if log_n <= tnc.LOCAL_LOG_MAX:
        src, dst = [v for row in rows for v in row], [None] * (B * n)
        _replay_local(src, dst, log_n, tnc.group_log(log_n, B, 1, False, sms), B, (n, 1), (n, 1),
                      inverse, scale=pow(n, P - 2, P) if inverse else None)
        return [dst[b * n:(b + 1) * n] for b in range(B)]
    log_n1 = log_n // 2
    log_n2 = log_n - log_n1
    n1, n2 = 1 << log_n1, 1 << log_n2
    table = [int(v) for v in tgl.to_u64(tnc.fourstep_twiddles(log_n1, log_n2, inverse, torch.device("cpu"))).reshape(-1)]
    out = []
    for row in rows:  # the grid's second axis: one batch row at a time
        mid, dst = [None] * n, [None] * n
        _replay_local(row, mid, log_n1, tnc.group_log(log_n1, n2, B, True, sms), n2, (1, n2), (1, n2),
                      inverse, post=(table, n2))
        _replay_local(mid, dst, log_n2, tnc.group_log(log_n2, n1, B, True, sms), n1, (n2, 1), (1, n1),
                      inverse)
        out.append(dst)
    return out


@pytest.mark.parametrize("log_n,B,sms", [(0, 3, 132), (1, 2, 132), (2, 5, 132), (3, 3, 132), (4, 2, 132),
                                         (7, 3, 132), (9, 2, 1), (11, 2, 1), (12, 1, 132), (12, 2, 1)])
def test_kernel_schedule_replayed_in_python_ints(log_n, B, sms):
    """The kernel's register passes (pass 1 from device memory in
    bit-reversed positions, three-stage passes with one twiddle product per
    element, the last pass to device memory), its shared-memory slots (no two
    elements of a block on one slot) and the four-step split at n = 2^12,
    replayed in Python ints with every loose value asserted below 2^64,
    equal the plain version both ways; ``sms`` = 1 keeps the largest groups
    of sequences, 132 (an H100) the split groups of a small grid."""
    a = _rand(90 + log_n, (B, 1 << log_n))
    a.reshape(-1)[1::5] = P - 1
    rows = [[int(v) for v in row] for row in a]
    for inverse in (False, True):
        want = tgl.to_u64(tnc.ntt_plain(tgl.from_u64(a, "cpu"), inverse))
        assert _replay_ntt(rows, inverse, sms) == want.tolist()


def test_kernel_tables_equal_exact_integers():
    # the powers of w_N, the 8th roots passed as arguments, and the pass plan
    for inverse in (False, True):
        for log_len in (0, 3, 9):
            w = tgl.primitive_root_of_unity(log_len)
            w = pow(w, P - 2, P) if inverse else w
            got = tgl.to_u64(tnc.root_powers(log_len, inverse, torch.device("cpu"))).tolist()
            assert got == [pow(w, i, P) for i in range(1 << log_len)]
        w8 = tgl.primitive_root_of_unity(3)
        w8 = pow(w8, P - 2, P) if inverse else w8
        assert tnc.eighth_roots(inverse) == (pow(w8, 2, P), w8, pow(w8, 3, P))
        assert pow(w8, 8, P) == 1 and pow(w8, 4, P) == P - 1
    assert [tnc.passes_for(m) for m in (0, 2, 3, 4, 6, 7, 9, 11)] == [
        (0,), (2,), (3,), (1, 3), (3, 3), (1, 3, 3), (3, 3, 3), (2, 3, 3, 3)]
    assert all(sum(tnc.passes_for(m)) == m for m in range(tnc.LOCAL_LOG_MAX + 1))
    # 8 strided sequences per block (64-byte segments) whatever the grid
    assert tnc.group_log(9, 512, 2, True, 132) == 3 and tnc.group_log(9, 512, 135, True, 132) == 3
    assert tnc.group_log(7, 256, 135, True, 132) == 5 and tnc.group_log(3, 5, 1, False, 132) == 0


def test_ntt_wrapper_rejects_bad_arguments():
    with pytest.raises(ValueError):
        tnc.ntt_cuda(torch.zeros((2, 12), dtype=torch.int64))  # not a power of two
    with pytest.raises(ValueError):
        tnc.ntt_cuda(torch.zeros((2, 2, 8), dtype=torch.int64))  # not [B, n]
    with pytest.raises(TypeError):
        tnc.ntt_cuda(torch.zeros((2, 8), dtype=torch.int32))


def test_ntt_definition_small():
    a = _rand(50, (8,))
    w = tgl.primitive_root_of_unity(3)
    want = [sum(int(a[j]) * pow(w, i * j, P) for j in range(8)) % P for i in range(8)]
    assert [int(v) for v in tgl.to_u64(tnt.ntt(a, device="cpu"))] == want


@pytest.mark.parametrize("log_n,rate_bits", [(3, 3), (6, 3), (9, 2)])
def test_coset_lde_ilde_match(log_n, rate_bits):
    a = _rand(60 + log_n, (2, 1 << log_n))
    want = np.asarray(jnt.coset_lde(jnp.asarray(a), rate_bits))
    got = tnt.coset_lde(a, rate_bits, device="cpu")
    assert (tgl.to_u64(got) == want).all()
    back = np.asarray(jnt.coset_ilde(jnp.asarray(want), rate_bits))
    assert (tgl.to_u64(tnt.coset_ilde(got, rate_bits)) == back).all()
    assert (back == a).all()
    # a non-default shift (FRI's squared shifts)
    want49 = np.asarray(jnt.coset_ilde(jnp.asarray(want), rate_bits, 49))
    assert (tgl.to_u64(tnt.coset_ilde(got, rate_bits, 49)) == want49).all()


def test_eval_poly_match():
    coeffs = _rand(70, (5, 16))
    x = _rand(71, (5,))
    want = np.asarray(jnt.eval_poly_at(jnp.asarray(coeffs), jnp.asarray(x)))
    got = tnt.eval_poly_at(tgl.from_u64(coeffs, "cpu"), tgl.from_u64(x, "cpu"))
    assert (tgl.to_u64(got) == want).all()
    xe = _rand(72, (2,))
    want_e = np.asarray(jnt.eval_poly_at_ext(jnp.asarray(coeffs), jnp.asarray(xe)))
    got_e = tnt.eval_poly_at_ext(tgl.from_u64(coeffs, "cpu"), tgl.from_u64(xe, "cpu"))
    assert (tgl.to_u64(got_e) == want_e).all()
