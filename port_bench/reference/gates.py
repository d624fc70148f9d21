"""The constraints of each gate the benchmark's circuits use, evaluated at
one point of the extension field.  A gate takes one row: its wires, its
constants and the hash of the public inputs."""

from __future__ import annotations

from . import field as f
from .poseidon import HALF_FULL, MDS, N_PARTIAL, ROUND_CONSTANTS, WIDTH, partial_round_tables

_A, _B = partial_round_tables()


def arithmetic(wires, consts, pi_hash):
    """20 ops a row: out = c0 * a * b + c1 * c on wires (4i .. 4i + 3)."""
    c0, c1 = consts[0], consts[1]
    return [f.sub(wires[4 * i + 3], f.add(f.mul(c0, f.mul(wires[4 * i], wires[4 * i + 1])),
                                          f.mul(c1, wires[4 * i + 2])))
            for i in range(20)]


def constant(wires, consts, pi_hash):
    return [f.sub(wires[i], consts[i]) for i in range(16)]


def public_input(wires, consts, pi_hash):
    return [f.sub(wires[i], (pi_hash[i], 0)) for i in range(4)]


def noop(wires, consts, pi_hash):
    return []


def _exp7(a):
    a3 = f.mul(f.mul(a, a), a)
    return f.mul(f.mul(a3, a3), a)


def _affine(row, basis):
    acc = (row[0], 0)
    for c, v in zip(row[1:], basis):
        if c:
            acc = f.add(acc, f.scale(v, c))
    return acc


def _full_round(state, rnd):
    rc = ROUND_CONSTANTS[WIDTH * rnd : WIDTH * rnd + WIDTH]
    boxed = [_exp7(f.add(state[i], (rc[i], 0))) for i in range(WIDTH)]
    out = []
    for r in range(WIDTH):
        acc = (0, 0)
        for c in range(WIDTH):
            acc = f.add(acc, f.scale(boxed[c], MDS[r][c]))
        out.append(acc)
    return out


def poseidon(wires, consts, pi_hash):
    """One permutation a row, with an input swap.  Wires: 0..11 in, 12..23
    out, 24 swap, 25..28 swap deltas, 29..64 the states entering rounds 1..3,
    65..86 the partial rounds' S-box inputs, 87..98 the state entering round
    26, 99..134 those entering rounds 27..29.  123 constraints, in this
    order."""
    cs = []
    swap = wires[24]
    cs.append(f.sub(f.mul(swap, swap), swap))
    for i in range(4):
        cs.append(f.sub(wires[25 + i], f.mul(swap, f.sub(wires[4 + i], wires[i]))))
    state = ([f.add(wires[i], wires[25 + i]) for i in range(4)]
             + [f.sub(wires[4 + i], wires[25 + i]) for i in range(4)] + wires[8:12])
    for r in range(3):
        nxt = _full_round(state, r)
        tgt = wires[29 + 12 * r : 41 + 12 * r]
        cs.extend(f.sub(t, v) for t, v in zip(tgt, nxt))
        state = tgt
    rc3 = ROUND_CONSTANTS[3 * WIDTH : 4 * WIDTH]
    ys = [_exp7(f.add(state[i], (rc3[i], 0))) for i in range(WIDTH)]
    xs = []
    for i in range(N_PARTIAL):
        b_i = wires[65 + i]
        cs.append(f.sub(b_i, _affine(_A[i][: 1 + WIDTH + i], ys + xs)))
        xs.append(_exp7(b_i))
    for lane in range(WIDTH):
        cs.append(f.sub(wires[87 + lane], _affine(_B[lane], ys + xs)))
    state = wires[87:99]
    for k in range(3):
        nxt = _full_round(state, HALF_FULL + N_PARTIAL + k)
        tgt = wires[99 + 12 * k : 111 + 12 * k]
        cs.extend(f.sub(t, v) for t, v in zip(tgt, nxt))
        state = tgt
    nxt = _full_round(state, 29)
    cs.extend(f.sub(wires[12 + i], nxt[i]) for i in range(WIDTH))
    return cs


# gate -> (constraints, constant slots)
GATES = {
    "arithmetic": (arithmetic, 2),
    "constant": (constant, 16),
    "noop": (noop, 0),
    "poseidon": (poseidon, 0),
    "public_input": (public_input, 0),
}
