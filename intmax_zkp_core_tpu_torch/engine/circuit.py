"""Circuit builder IR: targets, copy constraints, gate placement, and
``build()`` producing prover/verifier data.

This is the engine surface the reference consumes from plonky2
(``CircuitBuilder::{add_virtual_hash, add_virtual_bool_target_safe,
hash_n_to_hash_no_pad, split_le, range_check, arithmetic, connect,
connect_hashes, _if, is_equal, build}`` — usage cited throughout
``SURVEY.md`` §2.1).  Design notes:

* a Target is a virtual index; copy constraints are a union-find; routed
  wire *places* (row, col < num_routed) carry targets and enter the
  permutation argument; non-routed places are written directly by gate
  witness generators;
* every builder helper both emits constraints and registers a generator, so
  witness generation is one linear pass (with a fixpoint retry for
  out-of-order dependencies);
* ``build()`` lays out selector/constant/sigma columns, pads to a power of
  two with noop rows, and commits the preprocessed matrix with a Merkle cap
  (the ``constants_sigmas_cap`` that recursion later bakes into verifier
  data, reference ``recursion/gadgets/mod.rs:85-100``).
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from ..ops import goldilocks as gl
from ..ops import merkle as mk
from ..ops import ntt as nt
from ..ops import poseidon as ps
from ..ops.goldilocks import P_INT, primitive_root_of_unity
from .config import CircuitConfig
from .gates import (
    ArithmeticGate,
    ConstantGate,
    GATE_TYPES,
    PoseidonGate,
    PublicInputGate,
)

P = P_INT


@dataclass(frozen=True)
class HashOutTarget:
    elements: tuple  # 4 targets

    def __iter__(self):
        return iter(self.elements)


@dataclass(frozen=True)
class BoolTarget:
    target: int


class CircuitBuilder:
    def __init__(self, config: CircuitConfig | None = None, device=None):
        self.config = config or CircuitConfig.standard_recursion_config()
        # where build() commits the preprocessed matrix and where the built
        # circuit proves: None means the CUDA device (raises without one)
        self.device = gl.resolve_device(device)
        self.rows: list[tuple[str, list[int]]] = []  # (gate_id, constants)
        self.parent: list[int] = []  # union-find over targets
        self.place_of_target: dict[int, tuple[int, int]] = {}
        self.targets_at_place: dict[tuple[int, int], int] = {}
        self.generators: list = []
        self.preset_values: dict[int, int] = {}  # constants etc.
        self.public_input_targets: list[int] = []
        self._constant_cache: dict[int, int] = {}
        self._const_row: tuple[int, int] | None = None  # (row, next_slot)
        self._arith_rows: dict[tuple[int, int], tuple[int, int]] = {}
        self._u32_row: tuple[int, int] | None = None  # (row, next_op)
        self._zero: int | None = None
        self._one: int | None = None
        self._built = False

    # ---- targets & copy constraints ----

    def add_virtual_target(self) -> int:
        t = len(self.parent)
        self.parent.append(t)
        return t

    def add_virtual_targets(self, n: int) -> list[int]:
        return [self.add_virtual_target() for _ in range(n)]

    def add_virtual_hash(self) -> HashOutTarget:
        return HashOutTarget(tuple(self.add_virtual_targets(4)))

    def add_virtual_hashes(self, n: int) -> list[HashOutTarget]:
        return [self.add_virtual_hash() for _ in range(n)]

    def add_virtual_bool_target_safe(self) -> BoolTarget:
        """Virtual boolean with b*b = b enforced."""
        t = self.add_virtual_target()
        b2 = self.mul(t, t)
        self.connect(b2, t)
        return BoolTarget(t)

    def add_virtual_bool_target_unsafe(self) -> BoolTarget:
        return BoolTarget(self.add_virtual_target())

    def find(self, t: int) -> int:
        while self.parent[t] != t:
            self.parent[t] = self.parent[self.parent[t]]
            t = self.parent[t]
        return t

    def connect(self, a: int, b: int) -> None:
        ra, rb = self.find(a), self.find(b)
        if ra != rb:
            self.parent[ra] = rb

    def connect_hashes(self, a: HashOutTarget, b: HashOutTarget) -> None:
        for x, y in zip(a, b):
            self.connect(x, y)

    # ---- gate placement ----

    def add_gate(self, gate_id: str, constants: list[int] | None = None) -> int:
        assert not self._built
        self.rows.append((gate_id, list(constants or [])))
        return len(self.rows) - 1

    def _bind(self, row: int, col: int, target: int | None = None) -> int:
        """Bind a (possibly fresh) target to routed place (row, col)."""
        assert col < self.config.num_routed_wires
        key = (row, col)
        if key in self.targets_at_place:
            existing = self.targets_at_place[key]
            if target is not None:
                self.connect(existing, target)
            return existing
        if target is None:
            target = self.add_virtual_target()
        self.targets_at_place[key] = target
        if target not in self.place_of_target:
            self.place_of_target[target] = key
        return target

    # ---- constants ----

    def constant(self, c: int) -> int:
        c = c % P
        if c in self._constant_cache:
            return self._constant_cache[c]
        if self._const_row is None or self._const_row[1] >= ConstantGate.NUM_CONSTS:
            row = self.add_gate("constant", [0] * ConstantGate.NUM_CONSTS)
            self._const_row = (row, 0)
        row, slot = self._const_row
        self.rows[row][1][slot] = c
        t = self._bind(row, slot)
        self.preset_values[t] = c
        self._const_row = (row, slot + 1)
        self._constant_cache[c] = t
        return t

    def zero(self) -> int:
        if self._zero is None:
            self._zero = self.constant(0)
        return self._zero

    def one(self) -> int:
        if self._one is None:
            self._one = self.constant(1)
        return self._one

    def constant_hash(self, digest) -> HashOutTarget:
        return HashOutTarget(tuple(self.constant(int(e)) for e in digest))

    def constant_bool(self, b: bool) -> BoolTarget:
        return BoolTarget(self.one() if b else self.zero())

    def zero_hash(self) -> HashOutTarget:
        z = self.zero()
        return HashOutTarget((z, z, z, z))

    # ---- arithmetic ----

    def arithmetic(self, c0: int, c1: int, a: int, b: int, c: int) -> int:
        """out = c0*a*b + c1*c (plonky2 ``builder.arithmetic``)."""
        c0, c1 = c0 % P, c1 % P
        key = (c0, c1)
        cur = self._arith_rows.get(key)
        if cur is None or cur[1] >= ArithmeticGate.NUM_OPS:
            row = self.add_gate("arithmetic", [c0, c1])
            cur = (row, 0)
        row, op = cur
        base = 4 * op
        self._bind(row, base + 0, a)
        self._bind(row, base + 1, b)
        self._bind(row, base + 2, c)
        out = self._bind(row, base + 3)
        self._arith_rows[key] = (row, op + 1)
        self.generators.append(("arith", a, b, c, out, c0, c1))
        return out

    def mul(self, a: int, b: int) -> int:
        return self.arithmetic(1, 0, a, b, self.zero())

    def add(self, a: int, b: int) -> int:
        return self.arithmetic(1, 1, a, self.one(), b)

    def sub(self, a: int, b: int) -> int:
        return self.arithmetic(1, P - 1, a, self.one(), b)

    def mul_const(self, c: int, a: int) -> int:
        return self.arithmetic(c, 0, a, self.one(), self.zero())

    def mul_const_add(self, c0: int, a: int, b: int) -> int:
        """c0*a + b"""
        return self.arithmetic(c0, 1, a, self.one(), b)

    def add_many(self, ts) -> int:
        acc = self.zero()
        for t in ts:
            acc = self.add(acc, t)
        return acc

    def assert_zero(self, t: int) -> None:
        self.connect(t, self.zero())

    def assert_one(self, t: int) -> None:
        self.connect(t, self.one())

    def assert_bool(self, b: BoolTarget) -> None:
        t = b.target
        self.connect(self.mul(t, t), t)

    def u32_mul_add(self, a: int, b: int, c: int) -> tuple[int, int]:
        """(a*b + c) as (out_lo, out_hi) base-2^32 halves, both
        range-checked to 32 bits by the dedicated gate; requires a, b, c to
        themselves be < 2^32 for the split to be the unique integer
        decomposition (see ``U32MulAddGate``).  The building block of the
        non-native secp256k1 arithmetic used by the ECDSA feature."""
        from .gates import U32MulAddGate

        cur = self._u32_row
        if cur is None or cur[1] >= U32MulAddGate.NUM_OPS:
            row = self.add_gate("u32_mul_add")
            cur = (row, 0)
        row, op = cur
        self._bind(row, 5 * op + 0, a)
        self._bind(row, 5 * op + 1, b)
        self._bind(row, 5 * op + 2, c)
        out_lo = self._bind(row, 5 * op + 3)
        out_hi = self._bind(row, 5 * op + 4)
        self._u32_row = (row, op + 1)
        self.generators.append(("u32_mul_add", a, b, c, row, op, out_lo, out_hi))
        return out_lo, out_hi

    def range_check_u32(self, t: int) -> None:
        """Constrain t < 2^32 (one third of a u32 gate row)."""
        lo, _hi = self.u32_mul_add(t, self.one(), self.zero())
        self.connect(lo, t)

    def u32_split(self, t: int) -> tuple[int, int]:
        """Split t (known < 2^63 by construction at call sites) into
        (t mod 2^32, t >> 32), both range-checked."""
        return self.u32_mul_add(t, self.one(), self.zero())

    # ---- logic / selection ----

    def select(self, b: BoolTarget, x: int, y: int) -> int:
        """b ? x : y  =  y + b*(x - y)"""
        diff = self.sub(x, y)
        return self.arithmetic(1, 1, b.target, diff, y)

    def select_hash(self, b: BoolTarget, x: HashOutTarget, y: HashOutTarget) -> HashOutTarget:
        return HashOutTarget(tuple(self.select(b, xi, yi) for xi, yi in zip(x, y)))

    def is_equal(self, a: int, b: int) -> BoolTarget:
        """1 if a == b else 0, via inverse-or-zero witness (the same
        technique as the reference's ``InverseOrZeroGeneratorExtension``,
        ``transaction/gadgets/utils/mod.rs:19-68``)."""
        diff = self.sub(a, b)
        inv = self.add_virtual_target()
        self.generators.append(("inv_or_zero", diff, inv))
        prod = self.mul(diff, inv)
        is_eq = self.sub(self.one(), prod)
        # diff * is_eq == 0 enforces correctness of the witness
        self.assert_zero(self.mul(diff, is_eq))
        # inv must be the true inverse when diff != 0: (1 - diff*inv) * diff = 0
        # (already covered) and is_eq boolean follows
        return BoolTarget(is_eq)

    def not_(self, b: BoolTarget) -> BoolTarget:
        return BoolTarget(self.sub(self.one(), b.target))

    def and_(self, a: BoolTarget, b: BoolTarget) -> BoolTarget:
        return BoolTarget(self.mul(a.target, b.target))

    def or_(self, a: BoolTarget, b: BoolTarget) -> BoolTarget:
        # a + b - a*b
        ab = self.mul(a.target, b.target)
        return BoolTarget(self.sub(self.add(a.target, b.target), ab))

    # ---- decomposition ----

    def split_le(self, t: int, n_bits: int) -> list[BoolTarget]:
        """LE bit decomposition with booleanity + recomposition constraints
        (plonky2 ``split_le``, used for SMT key paths at
        ``process_smt.rs:183-189``)."""
        bits = []
        for _ in range(n_bits):
            bt = self.add_virtual_target()
            bits.append(bt)
        self.generators.append(("split_le", t, tuple(bits)))
        for bt in bits:
            self.connect(self.mul(bt, bt), bt)
        acc = self.zero()
        for i in reversed(range(n_bits)):
            acc = self.arithmetic(2, 1, acc, self.one(), bits[i])  # acc = 2*acc + bit
        self.connect(acc, t)
        return [BoolTarget(b) for b in bits]

    def range_check(self, t: int, n_bits: int) -> None:
        self.split_le(t, n_bits)

    def split_le_canonical(self, t: int) -> list[BoolTarget]:
        """64-bit LE decomposition with a canonicity constraint.

        A plain 64-bit ``split_le`` recomposes mod p, so values v < 2^32 - 1
        admit a second valid bit pattern (v + p fits in 64 bits) — a
        malicious prover could choose either, flipping derived FRI query
        indices or SMT key paths.  Enforce bits < p (p = 2^64 - 2^32 + 1:
        v >= p iff the high 32 bits are all one and the low 32 bits are
        nonzero) by asserting AND(high bits) * OR(low bits) == 0.
        """
        bits = self.split_le(t, 64)
        one = self.one()
        hi_and = bits[32].target
        for b in bits[33:]:
            hi_and = self.mul(hi_and, b.target)
        lo_nor = one  # product of (1 - bit) over the low 32 bits
        for b in bits[:32]:
            lo_nor = self.mul(lo_nor, self.sub(one, b.target))
        self.assert_zero(self.mul(hi_and, self.sub(one, lo_nor)))
        return bits

    # ---- Poseidon hashing ----

    def poseidon_permute(self, inputs: list[int], swap: BoolTarget | None = None) -> list[int]:
        assert len(inputs) == 12
        row = self.add_gate("poseidon")
        for i, t in enumerate(inputs):
            self._bind(row, PoseidonGate.W_IN + i, t)
        swap_t = swap.target if swap is not None else self.zero()
        self._bind(row, PoseidonGate.W_SWAP, swap_t)
        outs = [self._bind(row, PoseidonGate.W_OUT + i) for i in range(12)]
        self.generators.append(("poseidon", row, tuple(inputs), swap_t, tuple(outs)))
        return outs

    def hash_n_to_hash_no_pad(self, inputs: list[int]) -> HashOutTarget:
        """Sponge over any number of inputs (rate 8, overwrite absorb)."""
        state = [self.zero()] * 12
        for start in range(0, len(inputs), 8):
            chunk = inputs[start : start + 8]
            state = list(state)
            state[: len(chunk)] = chunk
            state = self.poseidon_permute(state)
        return HashOutTarget(tuple(state[:4]))

    def hash_pad(self, inputs: list[int]) -> HashOutTarget:
        padded = list(inputs) + [self.one()]
        while (len(padded) + 1) % 12 != 0:
            padded.append(self.zero())
        padded.append(self.one())
        return self.hash_n_to_hash_no_pad(padded)

    def two_to_one(self, left: HashOutTarget, right: HashOutTarget) -> HashOutTarget:
        return self.hash_n_to_hash_no_pad(list(left) + list(right))

    def two_to_one_swapped(
        self, left: HashOutTarget, right: HashOutTarget, swap: BoolTarget
    ) -> HashOutTarget:
        """H(swap ? (r,l) : (l,r)) using the Poseidon gate's swap wire."""
        state = list(left) + list(right) + [self.zero()] * 4
        out = self.poseidon_permute(state, swap=swap)
        return HashOutTarget(tuple(out[:4]))

    # ---- public inputs ----

    def register_public_input(self, t: int) -> None:
        self.public_input_targets.append(t)

    def register_public_inputs(self, ts) -> None:
        for t in ts:
            self.register_public_input(t)

    # ---- build ----

    def build(self) -> "CircuitData":
        assert not self._built
        # bind public-input hash: in-circuit hash of all PI targets routed
        # into the PublicInputGate row (plonky2's binding scheme)
        pi_hash = self.hash_n_to_hash_no_pad(list(self.public_input_targets))
        pi_row = self.add_gate("public_input")
        for i, t in enumerate(pi_hash):
            self._bind(pi_row, i, t)
        self._built = True

        cfg = self.config
        n_rows = len(self.rows)
        n = max(8, 1 << (n_rows - 1).bit_length())
        while n < n_rows:
            n <<= 1
        # pad with noop rows
        rows = self.rows + [("noop", [])] * (n - n_rows)

        gate_ids = sorted({g for g, _ in rows})
        sel_index = {g: i for i, g in enumerate(gate_ids)}
        n_sel = len(gate_ids)
        n_const_cols = max((GATE_TYPES[g].num_constant_slots for g in gate_ids), default=0)

        selectors = np.zeros((n_sel, n), dtype=np.uint64)
        const_cols = np.zeros((n_const_cols, n), dtype=np.uint64)
        for r, (g, consts) in enumerate(rows):
            selectors[sel_index[g], r] = 1
            for i, c in enumerate(consts):
                const_cols[i, r] = c

        # ---- sigma permutation over routed places ----
        R = cfg.num_routed_wires
        w_n = primitive_root_of_unity(n.bit_length() - 1)
        g_mult = 7  # multiplicative generator; k_j = g^j
        k_is = [pow(g_mult, j, P) for j in range(R)]
        # id value of place (row, col) = k_col * w^row
        dev = self.device
        w_pows_t = gl.powers(w_n, n, dev)
        w_pows = gl.to_u64(w_pows_t)

        # group places by copy class
        classes: dict[int, list[tuple[int, int]]] = {}
        for (row, col), t in self.targets_at_place.items():
            classes.setdefault(self.find(t), []).append((row, col))

        # identity layout + copy-class cycles, modmuls batched on device
        # (the scalar double loop costs seconds at block-circuit sizes)
        k_arr = np.array(k_is, dtype=np.uint64)
        k_t = gl.from_u64(k_arr, dev)
        sigma = gl.to_u64(gl.mul(k_t[:, None], w_pows_t[None, :])).copy()
        rows_i, cols_i, nrows_i, ncols_i = [], [], [], []
        for places in classes.values():
            if len(places) < 2:
                continue
            places = sorted(places)
            m = len(places)
            for i, (row, col) in enumerate(places):
                nrow, ncol = places[(i + 1) % m]
                rows_i.append(row)
                cols_i.append(col)
                nrows_i.append(nrow)
                ncols_i.append(ncol)
        if rows_i:
            vals = gl.to_u64(
                gl.mul(
                    gl.from_u64(k_arr[np.array(ncols_i)], dev),
                    gl.from_u64(w_pows[np.array(nrows_i)], dev),
                )
            )
            sigma[np.array(cols_i), np.array(rows_i)] = vals

        constants_sigmas = np.concatenate([selectors, const_cols, sigma], axis=0)

        # commit preprocessed matrix
        cs_coeffs_t = nt.intt(gl.from_u64(constants_sigmas, dev))
        cs_lde_t = nt.coset_lde(cs_coeffs_t, cfg.fri.rate_bits)
        cs_tree = mk.build_merkle_tree(cs_lde_t.t(), cfg.fri.cap_height)
        cs_coeffs = gl.to_u64(cs_coeffs_t)
        cs_lde = gl.to_u64(cs_lde_t)

        circuit_digest = ps.hash_no_pad_s(
            [x for d in cs_tree.cap for x in d] + [n, cfg.num_wires, cfg.num_challenges]
        )

        common = CommonCircuitData(
            config=cfg,
            n=n,
            gate_ids=gate_ids,
            n_sel=n_sel,
            n_const_cols=n_const_cols,
            k_is=k_is,
            num_public_inputs=len(self.public_input_targets),
            circuit_digest=tuple(circuit_digest),
            constants_sigmas_cap=[tuple(int(x) for x in d) for d in cs_tree.cap],
        )
        prover = ProverCircuitData(
            common=common,
            rows=rows,
            targets_at_place=dict(self.targets_at_place),
            parent=list(self.parent),
            generators=list(self.generators),
            preset_values=dict(self.preset_values),
            public_input_targets=list(self.public_input_targets),
            constants_sigmas=constants_sigmas,
            cs_coeffs=cs_coeffs,
            cs_lde=cs_lde,
            cs_tree=cs_tree,
            sigma=sigma,
            w_pows=w_pows,
        )
        return CircuitData(common=common, prover=prover, device=dev)


@dataclass
class CommonCircuitData:
    """Everything the verifier needs (plonky2 ``CommonCircuitData`` +
    ``VerifierOnlyCircuitData``)."""

    config: CircuitConfig
    n: int
    gate_ids: list[str]
    n_sel: int
    n_const_cols: int
    k_is: list[int]
    num_public_inputs: int
    circuit_digest: tuple
    constants_sigmas_cap: list


@dataclass
class ProverCircuitData:
    common: CommonCircuitData
    rows: list
    targets_at_place: dict
    parent: list[int]
    generators: list
    preset_values: dict
    public_input_targets: list[int]
    constants_sigmas: np.ndarray
    cs_coeffs: np.ndarray
    cs_lde: np.ndarray
    cs_tree: mk.MerkleTree
    sigma: np.ndarray
    w_pows: np.ndarray

    def find(self, t: int) -> int:
        parent = self.parent
        while parent[t] != t:
            parent[t] = parent[parent[t]]
            t = parent[t]
        return t

    # -- serialization (engine/circuit_cache.py): generators are declarative
    # records and the tables numpy, so the whole prover state pickles.  The
    # per-process cache a proof attaches, the witness fill plan, is
    # stripped (the device tables live in prover._KERNELS_CACHE, keyed by
    # digest); the cap is checked against the stored verifier data on load.

    def __getstate__(self):
        state = dict(self.__dict__)
        state.pop("_fill_plan", None)
        return state

    def __setstate__(self, state):
        self.__dict__.update(state)
        cap = [tuple(int(x) for x in d) for d in self.cs_tree.cap]
        if cap != list(self.common.constants_sigmas_cap):
            raise ValueError("reloaded constants/sigmas commitment does not match the stored cap")


@dataclass
class CircuitData:
    common: CommonCircuitData
    prover: ProverCircuitData
    device: object = None  # torch.device the circuit was built for

    # the device is the loader's (circuit_cache.bind_device), never the
    # writer's: a pickle holds none
    def __getstate__(self):
        return {**self.__dict__, "device": None}

    def prove(self, pw, fused_sponge: bool = False, timings=None) -> "object":
        from .prover import prove

        return prove(self, pw, fused_sponge=fused_sponge, timings=timings)

    def check_witness(self, pw) -> list:
        from .prover import check_witness

        return check_witness(self, pw)

    def verify(self, proof) -> None:
        from .verifier import verify

        return verify(self.common, proof)
