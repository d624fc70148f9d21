"""Native witness fill: run the declarative generator records
(engine/generators.py) through the C++ fixpoint engine, interleaving with
Python for model-registered kinds it does not know.  Bit-exact with
``engine.witness.WitnessFill``, the plain version the tests hold it against;
``engine.prover.compute_wire_matrix_plain`` runs that one, for comparisons
only.

Per circuit a *fill plan* is computed once and cached on the prover data:
the encoded record stream, fully path-compressed union-find roots, and the
(row, col) -> root arrays that let the wire matrix assemble with two numpy
scatters instead of a million-entry Python loop.
"""

from __future__ import annotations

import ctypes

import numpy as np

from .loader import witness_lib

# must match witness_native.cpp
NATIVE_KINDS = {
    "arith": 0,
    "inv_or_zero": 1,
    "split_le": 2,
    "poseidon": 3,
    "u32_mul_add": 4,
    "ext_inverse": 5,
}
_WIRES_PER = {"poseidon": 110, "u32_mul_add": 33}

P = 0xFFFFFFFF00000001


class FillPlan:
    def __init__(self, pd):
        n_targets = len(pd.parent)
        parent = np.array(pd.parent, dtype=np.int64)
        # full path compression by pointer jumping (log rounds)
        root = parent.copy()
        while True:
            nxt = root[root]
            if (nxt == root).all():
                break
            root = nxt
        self.parent = root.copy()  # flat: parent[t] == root[t]
        self.root_of = root
        self.n_targets = n_targets

        words: list[int] = []
        offsets: list[int] = []
        wire_capacity = 0
        python_records = []
        for rec in pd.generators:
            kind = rec[0] if isinstance(rec, tuple) else None
            if kind not in NATIVE_KINDS:
                python_records.append(rec)
                continue
            if kind == "split_le":
                _, t, bits = rec
                params = (t, len(bits), *bits)
            elif kind == "poseidon":
                _, row, inputs, swap_t, outs = rec
                params = (row, *inputs, swap_t, *outs)
            else:
                params = rec[1:]
            offsets.append(len(words))
            words.append(NATIVE_KINDS[kind])
            words.append(len(params))
            words.extend(int(v) % (1 << 64) for v in params)
            wire_capacity += _WIRES_PER.get(kind, 0)
        self.stream = np.array(words, dtype=np.uint64)
        self.rec_offsets = np.array(offsets, dtype=np.int64)
        self.n_records = len(offsets)
        self.wire_capacity = wire_capacity
        self.python_records = python_records

        # wire-place assembly tables
        places = pd.targets_at_place
        self.place_rows = np.fromiter(
            (rc[0] for rc in places.keys()), dtype=np.int64, count=len(places)
        )
        self.place_cols = np.fromiter(
            (rc[1] for rc in places.keys()), dtype=np.int64, count=len(places)
        )
        place_targets = np.fromiter(
            places.values(), dtype=np.int64, count=len(places)
        )
        self.place_roots = self.root_of[place_targets]
        self.pi_roots = self.root_of[
            np.array(pd.public_input_targets, dtype=np.int64)
        ] if pd.public_input_targets else np.empty(0, dtype=np.int64)
        self.preset_targets = np.array(list(pd.preset_values.keys()), dtype=np.int64)
        self.preset_values = np.array(
            [v % P for v in pd.preset_values.values()], dtype=np.uint64
        )


def get_fill_plan(pd) -> FillPlan:
    plan = getattr(pd, "_fill_plan", None)
    if plan is None:
        plan = FillPlan(pd)
        pd._fill_plan = plan
    return plan


class _ArrayFillView:
    """WitnessFill-compatible view over the plan's value arrays, used to run
    Python-side generator records between native passes."""

    def __init__(self, plan, values, has, wire_rows, wire_cols, wire_vals):
        self._root_of = plan.root_of
        self._values = values
        self._has = has
        self._wrows = wire_rows
        self._wcols = wire_cols
        self._wvals = wire_vals

    def get(self, t: int):
        r = self._root_of[t]
        if not self._has[r]:
            return None
        return int(self._values[r])

    def set(self, t: int, value: int) -> None:
        r = self._root_of[t]
        value = value % P
        if self._has[r]:
            existing = int(self._values[r])
            if existing != value:
                raise AssertionError(
                    f"conflicting witness values for target {t}: "
                    f"{existing} vs {value}"
                )
            return
        self._has[r] = 1
        self._values[r] = value

    def set_wire(self, row: int, col: int, value: int) -> None:
        self._wrows.append(row)
        self._wcols.append(col)
        self._wvals.append(value % P)


def _seed(view, targets, values) -> None:
    for t, v in zip(targets, values):
        view.set(int(t), int(v))


def native_fill(pd, pw):
    """Run witness generation natively.  Returns
    (values [n_targets] u64, has [n_targets] u8, wire_rows, wire_cols,
    wire_vals, plan) — wire arrays cover BOTH native and Python records."""
    from ..engine.generators import run_generator

    lib = witness_lib()
    plan = get_fill_plan(pd)
    n = plan.n_targets
    values = np.zeros(n, dtype=np.uint64)
    has = np.zeros(n, dtype=np.uint8)
    wire_rows = np.empty(plan.wire_capacity, dtype=np.int64)
    wire_cols = np.empty(plan.wire_capacity, dtype=np.int64)
    wire_vals = np.empty(plan.wire_capacity, dtype=np.uint64)
    py_wrows: list[int] = []
    py_wcols: list[int] = []
    py_wvals: list[int] = []
    view = _ArrayFillView(plan, values, has, py_wrows, py_wcols, py_wvals)

    _seed(view, plan.preset_targets, plan.preset_values)
    for t, v in pw.values.items():
        view.set(t, v)

    done = np.zeros(max(plan.n_records, 1), dtype=np.uint8)
    n_wires = ctypes.c_int64(0)
    conflict = ctypes.c_int64(-1)
    parent = plan.parent  # already flat; C++ compression is a no-op
    pending_py = list(plan.python_records)

    def c64(a):
        return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int64))

    def cu64(a):
        return a.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64))

    def cu8(a):
        return a.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))

    for _ in range(1000):
        # native pass runs its records to an internal fixpoint
        pending_native = 0
        if plan.n_records:
            pending_native = lib.witness_run(
                n, c64(parent), cu64(values), cu8(has),
                cu64(plan.stream), plan.n_records, c64(plan.rec_offsets),
                cu8(done),
                c64(wire_rows), c64(wire_cols), cu64(wire_vals),
                ctypes.byref(n_wires), ctypes.byref(conflict),
            )
            if pending_native < 0:
                raise AssertionError(
                    f"conflicting witness values for target {conflict.value}"
                )
        if not pending_py and pending_native == 0:
            break
        # one Python pass over the non-native records; if it makes no
        # progress the combined system is stuck (the native side already
        # reached its fixpoint on the current state)
        still = [rec for rec in pending_py if not run_generator(view, rec)]
        if len(still) == len(pending_py):
            raise AssertionError(
                "witness generation stuck: "
                f"{pending_native + len(still)} generators unresolved"
            )
        pending_py = still
    else:
        raise AssertionError("witness generation did not converge")

    nw = n_wires.value
    if py_wrows:
        wire_rows = np.concatenate([wire_rows[:nw], np.array(py_wrows, dtype=np.int64)])
        wire_cols = np.concatenate([wire_cols[:nw], np.array(py_wcols, dtype=np.int64)])
        wire_vals = np.concatenate([wire_vals[:nw], np.array(py_wvals, dtype=np.uint64)])
    else:
        wire_rows, wire_cols, wire_vals = (
            wire_rows[:nw], wire_cols[:nw], wire_vals[:nw],
        )
    return values, has, wire_rows, wire_cols, wire_vals, plan
