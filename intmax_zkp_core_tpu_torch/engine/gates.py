"""Gate definitions.

Each gate occupies one row and defines:
* how many wire columns it uses and which of them are routable;
* per-row constants (stored in preprocessed constant columns);
* ``eval_constraints(alg, wires, consts, public_hash)`` — the algebraic
  constraints, written against the algebra shim so the same code runs
  batched on the LDE coset (prover quotient) and at a point (verifier).

Gate set mirrors what the reference's circuits need from the engine
(``SURVEY.md`` §2.1): arithmetic ops, a full Poseidon permutation per row
(dominant — the SMT gadgets instantiate 2 per tree level,
``process_smt.rs:270-302``), constants, and the public-input anchor row.

The Poseidon gate follows the degree-7/135-wire design: full-round states
materialized, partial rounds expressed through the affine tables of
``ops.poseidon_fast`` over 22 lane-0 S-box wires.
"""

from __future__ import annotations

from ..ops.poseidon_constants import (
    ALL_ROUND_CONSTANTS,
    HALF_N_FULL_ROUNDS,
    MDS_MATRIX_CIRC,
    MDS_MATRIX_DIAG,
    N_PARTIAL_ROUNDS,
    SPONGE_WIDTH,
)
from ..ops.poseidon_fast import PARTIAL_A, PARTIAL_B

T = SPONGE_WIDTH

MDS_INT = [
    [
        (MDS_MATRIX_CIRC[(c - r) % T] + (MDS_MATRIX_DIAG[r] if r == c else 0))
        for c in range(T)
    ]
    for r in range(T)
]


class Gate:
    gate_id: str = "gate"
    num_constraints: int = 0
    num_constant_slots: int = 0

    def eval_constraints(self, alg, wires, consts, public_hash):
        raise NotImplementedError


class NoopGate(Gate):
    gate_id = "noop"
    num_constraints = 0

    def eval_constraints(self, alg, wires, consts, public_hash):
        return []


class ArithmeticGate(Gate):
    """NUM_OPS independent ops per row: out = c0 * a * b + c1 * c.

    Wires per op i: (4i, 4i+1, 4i+2, 4i+3) = (a, b, c, out); all ops on a
    row share the constants (c0, c1).  The counterpart of plonky2's
    ``ArithmeticGate`` behind ``builder.arithmetic`` (used throughout the
    reference's gadgets, e.g. ``common.rs:141-142``).
    """

    NUM_OPS = 20
    gate_id = "arithmetic"
    num_constraints = NUM_OPS
    num_constant_slots = 2

    def eval_constraints(self, alg, wires, consts, public_hash):
        c0, c1 = consts[0], consts[1]
        out = []
        for i in range(self.NUM_OPS):
            a, b, c, o = wires[4 * i], wires[4 * i + 1], wires[4 * i + 2], wires[4 * i + 3]
            term = alg.add(alg.mul(c0, alg.mul(a, b)), alg.mul(c1, c))
            out.append(alg.sub(o, term))
        return out


class ConstantGate(Gate):
    """wires[i] == const_slot[i] for i < NUM_CONSTS — the routing source for
    builder.constant()."""

    NUM_CONSTS = 16
    gate_id = "constant"
    num_constraints = NUM_CONSTS
    num_constant_slots = NUM_CONSTS

    def eval_constraints(self, alg, wires, consts, public_hash):
        return [alg.sub(wires[i], consts[i]) for i in range(self.NUM_CONSTS)]


class PublicInputGate(Gate):
    """wires[0..4] == H(public_inputs) — the hash is recomputed by both
    prover and verifier and enters constraint evaluation as a public value
    (plonky2's public-input binding)."""

    gate_id = "public_input"
    num_constraints = 4

    def eval_constraints(self, alg, wires, consts, public_hash):
        return [alg.sub(wires[i], public_hash[i]) for i in range(4)]


class U32MulAddGate(Gate):
    """NUM_OPS ops per row of ``a * b + c = out_lo + 2^32 * out_hi`` with
    both halves range-checked to 32 bits via 2-bit chunks (degree-4 chunk
    constraints), the workhorse of non-native secp256k1 arithmetic for the
    in-circuit ECDSA feature (the reference outsources this to its
    plonky2_ecdsa dependency — ``src/ecdsa/bin/ecdsa_verification.rs:52``
    uses ``verify_message_circuit`` built on just such a U32 gate).

    Wire layout per op i (i < 3):
      5i .. 5i+4            routed: a, b, c, out_lo, out_hi
      15 + 32i .. 15 + 32i + 31   non-routed: 16 + 16 2-bit chunks of
                                  out_lo and out_hi (LE)
      111 + i               non-routed: canonicity inverse witness u_i

    Soundness: for inputs a, b, c < 2^32 the integer value v = a*b + c is
    at most (2^32-1)^2 + (2^32-1) = 2^64 - 2^32 = p - 1, so the field
    equation never wraps.  The only non-canonical decomposition satisfying
    ``out_lo + 2^32*out_hi == v (mod p)`` with both halves < 2^32 is
    v + p (possible iff v < 2^32 - 1), which forces out_hi = 2^32 - 1;
    the honest split has out_hi = 2^32 - 1 only at v = p - 1, where
    out_lo = 0.  The constraint ``out_lo * (1 - (out_hi - (2^32-1)) * u)``
    with the inverse witness u therefore makes the split the unique
    base-2^32 decomposition of the integer a*b + c — which is what the
    nonnative-arithmetic column/carry equations built on this gate need."""

    NUM_OPS = 3
    gate_id = "u32_mul_add"
    num_constraints = NUM_OPS * 36
    CHUNK_BASE = 5 * NUM_OPS
    INV_BASE = 5 * NUM_OPS + 32 * NUM_OPS  # 111

    def eval_constraints(self, alg, wires, consts, public_hash):
        cs = []
        for i in range(self.NUM_OPS):
            a = wires[5 * i]
            b = wires[5 * i + 1]
            c = wires[5 * i + 2]
            out_lo = wires[5 * i + 3]
            out_hi = wires[5 * i + 4]
            chunks = [wires[self.CHUNK_BASE + 32 * i + k] for k in range(32)]
            term = alg.add(alg.mul(a, b), c)
            combined = alg.add(out_lo, alg.mul_const(out_hi, 1 << 32))
            cs.append(alg.sub(term, combined))
            for half, out in ((0, out_lo), (1, out_hi)):
                acc = None
                for k in range(16):
                    t = alg.mul_const(chunks[16 * half + k], 1 << (2 * k))
                    acc = t if acc is None else alg.add(acc, t)
                cs.append(alg.sub(out, acc))
            for ch in chunks:
                t1 = alg.mul(ch, alg.add_const(ch, P_NEG_ONE))
                t2 = alg.mul(
                    alg.add_const(ch, P_NEG_TWO), alg.add_const(ch, P_NEG_THREE)
                )
                cs.append(alg.mul(t1, t2))
            # canonicity: out_hi == 2^32-1 forces out_lo == 0
            u = wires[self.INV_BASE + i]
            diff = alg.add_const(out_hi, P_NEG_U32MAX)
            cs.append(alg.mul(out_lo, alg.sub(alg.const(1), alg.mul(diff, u))))
        assert len(cs) == self.num_constraints
        return cs

    @staticmethod
    def fill_op(a: int, b: int, c: int):
        """Witness values: (out_lo, out_hi, chunks[32], u) for a*b + c."""
        P = 0xFFFFFFFF00000001
        v = a * b + c
        out_lo = v & 0xFFFFFFFF
        out_hi = v >> 32
        chunks = [(out_lo >> (2 * k)) & 3 for k in range(16)] + [
            (out_hi >> (2 * k)) & 3 for k in range(16)
        ]
        diff = (out_hi - 0xFFFFFFFF) % P
        u = pow(diff, P - 2, P) if diff else 0
        return out_lo, out_hi, chunks, u


P_NEG_ONE = 0xFFFFFFFF00000000  # -1 mod p
P_NEG_TWO = 0xFFFFFFFEFFFFFFFF  # -2 mod p
P_NEG_THREE = 0xFFFFFFFEFFFFFFFE  # -3 mod p
P_NEG_U32MAX = (0xFFFFFFFF00000001 - 0xFFFFFFFF) % 0xFFFFFFFF00000001  # -(2^32-1)


class PoseidonGate(Gate):
    """One full Poseidon-12 permutation per row, with input-pair swap.

    Wire layout (135 wires):
      0..11    in        (pre-swap)
      12..23   out
      24       swap      (boolean; swaps in[0..4] with in[4..8])
      25..28   delta_i = swap * (in[4+i] - in[i])
      29..64   states before full rounds 1, 2, 3          (3 x 12)
      65..86   partial-round lane-0 S-box inputs b_i      (22)
      87..98   state before full round 26 (S26)           (12)
      99..134  states before full rounds 27, 28, 29       (3 x 12)

    Constraint degrees stay <= 7 because the partial section is expressed
    through the affine tables over Y_j = sbox(full1_r3[j] + c3[j]) and
    x_i = sbox(b_i) (see ops.poseidon_fast).
    """

    gate_id = "poseidon"

    W_IN = 0
    W_OUT = 12
    W_SWAP = 24
    W_DELTA = 25
    W_FULL1 = 29  # 3 blocks of 12
    W_PARTIAL = 65  # 22
    W_S26 = 87  # 12
    W_FULL2 = 99  # 3 blocks of 12

    NUM_WIRES_USED = 135
    num_constraints = 1 + 4 + 12 + 24 + 22 + 12 + 36 + 12  # = 123

    def eval_constraints(self, alg, wires, consts, public_hash):
        cs = []
        swap = wires[self.W_SWAP]
        # swap is boolean
        cs.append(alg.sub(alg.mul(swap, swap), swap))
        # delta_i = swap * (in[4+i] - in[i])
        for i in range(4):
            diff = alg.sub(wires[self.W_IN + 4 + i], wires[self.W_IN + i])
            cs.append(alg.sub(wires[self.W_DELTA + i], alg.mul(swap, diff)))
        # swapped input
        sin = []
        for i in range(4):
            sin.append(alg.add(wires[self.W_IN + i], wires[self.W_DELTA + i]))
        for i in range(4):
            sin.append(alg.sub(wires[self.W_IN + 4 + i], wires[self.W_DELTA + i]))
        for i in range(8, 12):
            sin.append(wires[self.W_IN + i])

        def mds(vals):
            out = []
            for r in range(T):
                acc = None
                for c in range(T):
                    term = alg.mul_const(vals[c], MDS_INT[r][c])
                    acc = term if acc is None else alg.add(acc, term)
                out.append(acc)
            return out

        def full_round(state, rnd):
            rc = ALL_ROUND_CONSTANTS[T * rnd : T * rnd + T]
            sboxed = [alg.exp7(alg.add_const(state[i], rc[i])) for i in range(T)]
            return mds(sboxed), sboxed

        # rounds 0..2: next state materialized as wires
        state = sin
        for r in range(3):
            nxt, _ = full_round(state, r)
            tgt = [wires[self.W_FULL1 + 12 * r + i] for i in range(T)]
            cs.extend(alg.sub(tgt[i], nxt[i]) for i in range(T))
            state = tgt
        # round 3: produce Y (sbox outputs); S4 = MDS*Y is implicit
        rc3 = ALL_ROUND_CONSTANTS[T * 3 : T * 4]
        Y = [alg.exp7(alg.add_const(state[i], rc3[i])) for i in range(T)]
        # partial rounds: b_i and S26 via affine tables over [1, Y, x]
        xs = []
        for i in range(N_PARTIAL_ROUNDS):
            row = PARTIAL_A[i]
            acc = alg.const(row[0])
            for j in range(T):
                if row[1 + j]:
                    acc = alg.add(acc, alg.mul_const(Y[j], row[1 + j]))
            for j in range(i):
                if row[1 + T + j]:
                    acc = alg.add(acc, alg.mul_const(xs[j], row[1 + T + j]))
            b_i = wires[self.W_PARTIAL + i]
            cs.append(alg.sub(b_i, acc))
            xs.append(alg.exp7(b_i))
        for lane in range(T):
            row = PARTIAL_B[lane]
            acc = alg.const(row[0])
            for j in range(T):
                if row[1 + j]:
                    acc = alg.add(acc, alg.mul_const(Y[j], row[1 + j]))
            for j in range(N_PARTIAL_ROUNDS):
                if row[1 + T + j]:
                    acc = alg.add(acc, alg.mul_const(xs[j], row[1 + T + j]))
            cs.append(alg.sub(wires[self.W_S26 + lane], acc))
        # full rounds 26..28 materialize the next state
        state = [wires[self.W_S26 + i] for i in range(T)]
        for k in range(3):
            rnd = HALF_N_FULL_ROUNDS + N_PARTIAL_ROUNDS + k  # 26, 27, 28
            nxt, _ = full_round(state, rnd)
            tgt = [wires[self.W_FULL2 + 12 * k + i] for i in range(T)]
            cs.extend(alg.sub(tgt[i], nxt[i]) for i in range(T))
            state = tgt
        # round 29 -> out
        nxt, _ = full_round(state, 29)
        cs.extend(alg.sub(wires[self.W_OUT + i], nxt[i]) for i in range(T))
        assert len(cs) == self.num_constraints
        return cs

    def eval_constraints_batched(self, wires, consts, public_hash):
        """Vectorized batched evaluation over [L] wire tensors — identical
        constraints to ``eval_constraints`` but built from tensor-level ops
        (stacked lanes, the MDS as a matrix product, each affine table row as
        one product over its basis and a halving sum).  Used by the prover's quotient; the
        verifier's point evaluation uses the generic scalar path."""
        import torch

        from ..ops import goldilocks as gl
        from ..ops.poseidon import _mds_layer, _round_constants, _sbox as sbox

        device = wires[0].device
        rc_all = _round_constants(device)

        def stack(cols):
            return torch.stack([c.expand(wires[0].shape) for c in cols])

        def mds(state):
            return _mds_layer(state, dim=0)  # state [12, L]

        def rc_vec(rnd):
            return rc_all[rnd][:, None]

        # the affine tables' basis [Y_0..Y_11, x_0..x_21]; x_i is filled in as made
        basis = torch.empty((T + N_PARTIAL_ROUNDS,) + wires[0].shape, dtype=torch.int64,
                            device=device)

        def table_rows(rows, n_x):
            """row[0] + sum_j row[1 + j] * basis[j] over the first T + n_x basis
            rows, for every row of ``rows``: one product and a halving sum (the
            arithmetic is exact mod p, so this equals a term-by-term fold)."""
            m = T + n_x
            coef = torch.tensor([[gl.i64(r[1 + j] % gl.P_INT) for j in range(m)] for r in rows],
                                dtype=torch.int64, device=device)
            t = gl.mul(basis[None, :m], coef[:, :, None])  # [rows, m, L]
            while t.shape[1] > 1:
                if t.shape[1] % 2:
                    t = torch.cat([t, torch.zeros_like(t[:, :1])], dim=1)
                half = t.shape[1] // 2
                t = gl.add(t[:, :half], t[:, half:])
            const = torch.tensor([gl.i64(r[0] % gl.P_INT) for r in rows], dtype=torch.int64,
                                 device=device)
            return gl.add(const[:, None], t[:, 0])

        cs = []
        swap = wires[self.W_SWAP]
        cs.append(gl.sub(gl.mul(swap, swap), swap))
        delta = stack([wires[self.W_DELTA + i] for i in range(4)])
        in_lo = stack([wires[self.W_IN + i] for i in range(4)])
        in_hi = stack([wires[self.W_IN + 4 + i] for i in range(4)])
        diff = gl.sub(in_hi, in_lo)
        delta_expect = gl.mul(swap.expand(diff.shape), diff)
        for i in range(4):
            cs.append(gl.sub(delta[i], delta_expect[i]))
        sin = torch.cat(
            [
                gl.add(in_lo, delta),
                gl.sub(in_hi, delta),
                stack([wires[self.W_IN + i] for i in range(8, 12)]),
            ]
        )

        state = sin
        for r in range(3):
            nxt = mds(sbox(gl.add(state, rc_vec(r))))
            tgt = stack([wires[self.W_FULL1 + 12 * r + i] for i in range(12)])
            diffs = gl.sub(tgt, nxt)
            cs.extend(diffs[i] for i in range(12))
            state = tgt
        basis[:T] = sbox(gl.add(state, rc_vec(3)))  # Y [12, L]

        b_stack = stack([wires[self.W_PARTIAL + i] for i in range(N_PARTIAL_ROUNDS)])
        for i in range(N_PARTIAL_ROUNDS):
            cs.append(gl.sub(b_stack[i], table_rows([PARTIAL_A[i]], i)[0]))
            basis[T + i] = sbox(b_stack[i])
        s26 = stack([wires[self.W_S26 + i] for i in range(12)])
        diffs = gl.sub(s26, table_rows(PARTIAL_B, N_PARTIAL_ROUNDS))
        cs.extend(diffs[lane] for lane in range(T))

        state = s26
        for k in range(3):
            rnd = HALF_N_FULL_ROUNDS + N_PARTIAL_ROUNDS + k
            nxt = mds(sbox(gl.add(state, rc_vec(rnd))))
            tgt = stack([wires[self.W_FULL2 + 12 * k + i] for i in range(12)])
            diffs = gl.sub(tgt, nxt)
            cs.extend(diffs[i] for i in range(12))
            state = tgt
        nxt = mds(sbox(gl.add(state, rc_vec(29))))
        out = stack([wires[self.W_OUT + i] for i in range(12)])
        diffs = gl.sub(out, nxt)
        cs.extend(diffs[i] for i in range(12))
        assert len(cs) == self.num_constraints
        return cs

    # --- witness-side: compute all intermediate wire values ---

    @staticmethod
    def fill_row(inputs, swap: int):
        """Returns a dict {wire_col: value} for all wires given the 12
        pre-swap inputs and the swap flag."""
        from ..ops.poseidon_constants import ALL_ROUND_CONSTANTS as RC

        P = 0xFFFFFFFF00000001

        def sbox(x):
            x2 = x * x % P
            x3 = x2 * x % P
            return x3 * x3 % P * x % P

        def mds_s(v):
            return [sum(MDS_INT[r][c] * v[c] for c in range(T)) % P for r in range(T)]

        vals = {}
        for i in range(T):
            vals[PoseidonGate.W_IN + i] = inputs[i]
        vals[PoseidonGate.W_SWAP] = swap
        delta = [swap * ((inputs[4 + i] - inputs[i]) % P) % P for i in range(4)]
        for i in range(4):
            vals[PoseidonGate.W_DELTA + i] = delta[i]
        sin = [(inputs[i] + delta[i]) % P for i in range(4)]
        sin += [(inputs[4 + i] - delta[i]) % P for i in range(4)]
        sin += [inputs[i] for i in range(8, 12)]

        state = sin
        for r in range(3):
            state = mds_s([sbox((state[i] + RC[T * r + i]) % P) for i in range(T)])
            for i in range(T):
                vals[PoseidonGate.W_FULL1 + 12 * r + i] = state[i]
        Y = [sbox((state[i] + RC[T * 3 + i]) % P) for i in range(T)]
        xs = []
        basis = [1] + Y + [0] * N_PARTIAL_ROUNDS
        for i in range(N_PARTIAL_ROUNDS):
            b_i = sum(a * v for a, v in zip(PARTIAL_A[i], basis)) % P
            vals[PoseidonGate.W_PARTIAL + i] = b_i
            basis[1 + T + i] = sbox(b_i)
        s26 = [
            sum(a * v for a, v in zip(PARTIAL_B[lane], basis)) % P for lane in range(T)
        ]
        for i in range(T):
            vals[PoseidonGate.W_S26 + i] = s26[i]
        state = s26
        for k in range(3):
            rnd = HALF_N_FULL_ROUNDS + N_PARTIAL_ROUNDS + k
            state = mds_s([sbox((state[i] + RC[T * rnd + i]) % P) for i in range(T)])
            for i in range(T):
                vals[PoseidonGate.W_FULL2 + 12 * k + i] = state[i]
        out = mds_s([sbox((state[i] + RC[T * 29 + i]) % P) for i in range(T)])
        for i in range(T):
            vals[PoseidonGate.W_OUT + i] = out[i]
        return vals


GATE_TYPES = {
    g.gate_id: g
    for g in [
        NoopGate(),
        ArithmeticGate(),
        ConstantGate(),
        PublicInputGate(),
        PoseidonGate(),
        U32MulAddGate(),
    ]
}
