"""K3, the permutation-argument columns: the port's plain version against the
JAX package's eager limb twin of its Pallas kernel, bit for bit.

Same inputs from a numpy seed through ``perm_columns_jnp_limb`` (the tile
computation of the Pallas kernel run eagerly, as the JAX package's own CPU
test runs it) and through ``perm_columns_plain`` / ``perm_columns_cuda`` of
the port (on the CPU the wrapper takes the plain version).  Tolerance 0."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from intmax_zkp_core_tpu.ops.perm_columns_pallas import perm_columns_jnp_limb
from intmax_zkp_core_tpu_torch.ops import goldilocks as gl
from intmax_zkp_core_tpu_torch.ops import perm_columns_cuda as pcol

torch.set_num_threads(1)

P = gl.P_INT
N, C = 64, 2


def _inputs(R, K=1, seed=41):
    rng = np.random.default_rng(seed + R)
    wires = rng.integers(0, P, size=(K, R, N), dtype=np.uint64)
    wires.reshape(-1)[::7] = 0  # lanes of 0 and p-1
    wires.reshape(-1)[3::11] = P - 1
    id_vals = rng.integers(0, P, size=(R, N), dtype=np.uint64)
    sigma = rng.integers(0, P, size=(R, N), dtype=np.uint64)
    betas = rng.integers(1, P, size=(K, C), dtype=np.uint64)
    gammas = rng.integers(1, P, size=(K, C), dtype=np.uint64)
    return wires, betas, gammas, id_vals, sigma


def _t(*arrays):
    return [gl.from_u64(a, "cpu") for a in arrays]


@pytest.mark.parametrize("R", [3, 7, 16, 23])
def test_perm_columns_plain_equals_jax(R):
    wires, betas, gammas, id_vals, sigma = _inputs(R)
    jz, jpp, jwrap = perm_columns_jnp_limb(
        jnp.asarray(wires[0]), jnp.asarray(betas[0]), jnp.asarray(gammas[0]),
        jnp.asarray(id_vals), jnp.asarray(sigma),
    )
    z, pp, wrap = pcol.perm_columns_plain(*_t(wires, betas, gammas, id_vals, sigma))
    nch = (R + 6) // 7
    assert z.shape == (1, C, N) and pp.shape == (1, C, nch - 1, N) and wrap.shape == (1, C)
    assert np.array_equal(gl.to_u64(z[0]), np.asarray(jz))
    assert np.array_equal(gl.to_u64(pp[0]), np.asarray(jpp))
    assert np.array_equal(gl.to_u64(wrap[0]), np.asarray(jwrap))


@pytest.mark.parametrize("R", [3, 7, 16, 23])
def test_wrapper_on_cpu_takes_the_plain_version_and_batches(R):
    # K = 2 in one call against two single calls; extra wire rows are ignored
    wires, betas, gammas, id_vals, sigma = _inputs(R, K=2)
    wide = np.concatenate([wires, np.full((2, 2, N), 5, dtype=np.uint64)], axis=1)
    tw, tb, tg, ti, ts = _t(wide, betas, gammas, id_vals, sigma)
    before = pcol.cb.launch_counts()
    z, pp, wrap = pcol.perm_columns_cuda(tw, tb, tg, ti, ts)
    assert pcol.cb.launch_counts() == before  # a CPU tensor launches nothing
    for k in range(2):
        zk, ppk, wrapk = pcol.perm_columns_plain(
            *_t(wires[k : k + 1], betas[k : k + 1], gammas[k : k + 1], id_vals, sigma)
        )
        assert torch.equal(z[k], zk[0]) and torch.equal(pp[k], ppk[0])
        assert torch.equal(wrap[k], wrapk[0])


@pytest.mark.parametrize("R", [7, 23])
def test_stage1_outputs_are_what_they_are_called(R):
    # f_pref / g_pref_inv / row_quot against exact Python ints on a few points
    wires, betas, gammas, id_vals, sigma = _inputs(R)
    f_pref, g_pref_inv, row_quot = (
        gl.to_u64(t) for t in pcol.stage1_plain(*_t(wires, betas, gammas, id_vals, sigma))
    )
    nch = (R + 6) // 7
    for c in range(C):
        beta, gamma = int(betas[0, c]), int(gammas[0, c])
        for x in (0, 1, N - 1):
            f = g = 1
            for j in range(nch):
                for i in range(7 * j, min(7 * j + 7, R)):
                    w = int(wires[0, i, x])
                    f = f * ((w + beta * int(id_vals[i, x]) + gamma) % P) % P
                    g = g * ((w + beta * int(sigma[i, x]) + gamma) % P) % P
                assert int(f_pref[0, c, j, x]) == f
                if j < nch - 1:
                    assert int(g_pref_inv[0, c, j, x]) == pow(g, P - 2, P)
            assert int(row_quot[0, c, x]) == f * pow(g, P - 2, P) % P


def test_wrapper_refuses_what_the_kernel_cannot_take():
    wires, betas, gammas, id_vals, sigma = _t(*_inputs(7))
    with pytest.raises(TypeError):
        pcol.perm_columns_cuda(wires.to(torch.int32), betas, gammas, id_vals, sigma)
    with pytest.raises(ValueError):
        pcol.perm_columns_cuda(wires[:, :5], betas, gammas, id_vals, sigma)  # fewer rows than R
    with pytest.raises(ValueError):
        pcol.perm_columns_cuda(wires, betas, gammas, id_vals, sigma[:, :8])


# The kernels' schedule (csrc/perm_columns.cu) in Python ints: pass A per
# (proof, challenge, point), the loose arithmetic of goldilocks.cuh
# (every value asserted below 2^64 by the helpers), the block scans of passes
# A and B and the elementwise pass C, at block sizes small enough that several
# blocks, several warps and more block totals than one scan step hold are
# exercised.
from test_torch_gate_quotient import _add, _canon, _reduce128  # noqa: E402
from test_torch_perm_quotient import _chain, _mul  # noqa: E402

EDGE_LANES = (0, 1, (1 << 32) - 1, 1 << 32, 1 << 63, P - 1)


def _inv(x):  # inv_loose: gl_inv's addition chain on loose values
    def sqn_mul(v, n, y):
        for _ in range(n):
            v = _mul(v, v)
        return _mul(v, y)

    c2 = sqn_mul(x, 1, x)
    c4 = sqn_mul(c2, 2, c2)
    c8 = sqn_mul(c4, 4, c4)
    t = sqn_mul(sqn_mul(sqn_mul(sqn_mul(c8, 8, c8), 8, c8), 4, c4), 2, c2)
    c31 = sqn_mul(t, 1, x)
    return sqn_mul(c31, 33, sqn_mul(c31, 1, x))


def _block_scan(xs, warp):  # block_scan<THREADS> -> (exclusive products, total)
    incl, d = list(xs), 1
    while d < warp:  # Hillis-Steele within each warp, through shuffles
        incl = [_mul(v, incl[i - d]) if i % warp >= d else v for i, v in enumerate(incl)]
        d *= 2
    warp_tot = incl[warp - 1 :: warp]
    total, out = 1, []
    for v in warp_tot:
        total = _mul(total, v)
    for i in range(len(xs)):
        pre = 1
        for v in warp_tot[: i // warp]:
            pre = _mul(pre, v)
        out.append(pre if i % warp == 0 else _mul(pre, incl[i - 1]))
    return out, total


def _pass_a_thread(w, id_col, sigma_col, beta, gamma):
    """perm_columns_rows_kernel's thread at one (proof, challenge, point) ->
    (its q_j slots, its row_quot), loose."""
    R = len(w)
    nch = (R + 6) // 7
    slots = [None] * (nch - 1)  # F_pref[j], then q_j
    mid = [None] * max(nch - 2, 0)  # g_j, 0 < j < nch - 1
    for j in range(nch):  # one walk: fused multiply-adds, w_i + gamma shared by f_i and g_i
        rows = range(7 * j, min(7 * j + 7, R))
        wg = [_add(w[i], gamma) for i in rows]
        f = _chain([_reduce128(beta * id_col[i] + v) for i, v in zip(rows, wg)])
        g = _chain([_reduce128(beta * sigma_col[i] + v) for i, v in zip(rows, wg)])
        F = f if j == 0 else _mul(F, f)
        G = g if j == 0 else _mul(G, g)
        if j < nch - 1:
            slots[j] = F
        if 0 < j < nch - 1:
            mid[j - 1] = g
    inv = _inv(G)
    for j in reversed(range(nch - 1)):  # back: q_j = F_pref[j] * G_suff[j+1] / G_total
        slots[j] = _mul(_mul(slots[j], g), inv)
        if j > 0:
            g = _mul(g, mid[j - 1])
    return slots, _mul(F, inv)


def _replay(wires, betas, gammas, id_vals, sigma, rows, scan, warp):
    """The three passes at blocks of ``rows`` points (pass A and C), scan
    steps of ``scan`` block totals (pass B) and warps of ``warp`` lanes ->
    (z, pp, wrap) as nested lists of ints."""
    K, R, n = wires.shape
    C = betas.shape[1]
    nch = (R + 6) // 7
    nb = -(-n // rows)
    col = lambda a, t: [int(v) for v in a[:, t]]  # noqa: E731
    z = [[None] * n for _ in range(K * C)]
    pp = [[[None] * n for _ in range(nch - 1)] for _ in range(K * C)]
    wrap = []
    for k in range(K):
        quot = [[1] * (nb * rows) for _ in range(C)]  # the identity beyond the last point
        for c in range(C):
            for t in range(n):
                slots, quot[c][t] = _pass_a_thread(col(wires[k], t), col(id_vals, t), col(sigma, t),
                                                   int(betas[k, c]), int(gammas[k, c]))
                for j in range(nch - 1):
                    pp[k * C + c][j][t] = slots[j]
        for c in range(C):
            kc, totals = k * C + c, []
            for blk in range(nb):  # pass A's scan of each block
                before, total = _block_scan(quot[c][blk * rows : (blk + 1) * rows], warp)
                totals.append(total)
                for i, v in enumerate(before):
                    if blk * rows + i < n:
                        z[kc][blk * rows + i] = v
            carry, carries = 1, []
            for base in range(0, nb, scan):  # pass B, in steps of `scan` totals
                step_vals = totals[base : base + scan]
                before, step = _block_scan(step_vals + [1] * (scan - len(step_vals)), warp)
                carries += [_mul(carry, v) for v in before[: len(step_vals)]]
                carry = _mul(carry, step)
            wrap.append(_canon(carry))
            for t in range(n):  # pass C
                z[kc][t] = _canon(_mul(carries[t // rows], z[kc][t]))
                for j in range(nch - 1):
                    pp[kc][j][t] = _canon(_mul(z[kc][t], pp[kc][j][t]))
    return z, pp, wrap


def _edge_inputs(R, K, n, seed):
    """Canonical inputs whose lanes run through 0, 1, 2^32 - 1, 2^32, 2^63
    and p - 1, with point 5 of proof 0 holding a zero g-factor (so a zero
    g total) for challenge 0."""
    wires, betas, gammas, id_vals, sigma = _inputs(R, K, seed)
    wires, id_vals, sigma = (a[..., :n].copy() for a in (wires, id_vals, sigma))
    for a in (wires, id_vals, sigma):
        flat = a.reshape(-1)
        for i, v in enumerate(EDGE_LANES):
            flat[3 * i + 1 :: 5 * len(EDGE_LANES) + 1] = v
    beta, gamma = int(betas[0, 0]), int(gammas[0, 0])
    wires[0, R - 1, 5] = (-(beta * int(sigma[R - 1, 5]) + gamma)) % P
    return wires, betas, gammas, id_vals, sigma


@pytest.mark.parametrize("R", [5, 23])
def test_kernel_schedule_replayed_in_python_ints(R):
    # 61 and 37 points: blocks of 8 divide neither; 8 and 5 block totals
    # against scan steps of 4; warps of 2 lanes, so 4 warps a block of 8
    K, n = (1, 61) if R == 23 else (2, 37)
    wires, betas, gammas, id_vals, sigma = _edge_inputs(R, K, n, seed=60)
    want = [gl.to_u64(t) for t in pcol.perm_columns_plain(*_t(wires, betas, gammas, id_vals, sigma))]
    z, pp, wrap = _replay(wires, betas, gammas, id_vals, sigma, rows=8, scan=4, warp=2)
    nch = (R + 6) // 7
    assert np.array_equal(np.array(z, dtype=np.uint64).reshape(K, C, n), want[0])
    assert np.array_equal(np.array(pp, dtype=np.uint64).reshape(K, C, nch - 1, n), want[1])
    assert np.array_equal(np.array(wrap, dtype=np.uint64).reshape(K, C), want[2])
    # the zero g total at point 5 of challenge 0: row_quot 0 there, so Z is 0 after it,
    # and challenge 1 is untouched by it
    assert not want[0][0, 0, 6:].any() and want[0][0, 0, 5] != 0 and want[0][0, 1, 6:].all()
    assert max(want[0].max(), want[2].max()) < P
