"""Declarative witness generators.

The reference's witness generation runs ``SimpleGenerator`` trait objects
(e.g. ``InverseOrZeroGeneratorExtension``, reference
``src/transaction/gadgets/utils/mod.rs:19-68``).  Here every generator is a
plain data record ``(kind, *params)`` where ``kind`` names a pure function
in ``GENERATOR_KINDS`` and the params are ints / tuples of ints.  Records
instead of closures buy two framework features:

* **circuit serialization** — a built ``CircuitData`` (rows, copy classes,
  sigmas, generators) pickles to disk and reloads in a fresh process,
  skipping the entire build step (``engine/circuit_cache.py``);
* a future native (C++) witness interpreter can execute the same records.

Model layers register their own kinds at import time via
``register_generator_kind`` (see ``models/ecdsa/gadgets.py``); unpickling a
circuit re-imports those modules through its target dataclasses, so the
registry is always populated before a fill runs.

Every kind function takes the ``WitnessFill`` followed by the record params
and returns ``True`` when it made progress (all inputs were available) or
``False`` to be retried next fixpoint round.
"""

from __future__ import annotations

from ..ops.goldilocks import P_INT

P = P_INT

GENERATOR_KINDS: dict = {}


def register_generator_kind(name: str, fn) -> None:
    existing = GENERATOR_KINDS.get(name)
    if existing is not None and existing is not fn:
        raise ValueError(f"generator kind {name!r} already registered")
    GENERATOR_KINDS[name] = fn


def run_generator(w, rec) -> bool:
    if isinstance(rec, tuple):
        return GENERATOR_KINDS[rec[0]](w, *rec[1:])
    return rec(w)  # legacy callable (not serializable)


# ---------------------------------------------------------------------------
# engine kinds
# ---------------------------------------------------------------------------


def _gen_arithmetic(w, a, b, c, out, c0, c1):
    va, vb, vc = w.get(a), w.get(b), w.get(c)
    if va is None or vb is None or vc is None:
        return False
    w.set(out, (c0 * va * vb + c1 * vc) % P)
    return True


def _gen_inverse_or_zero(w, src, inv):
    v = w.get(src)
    if v is None:
        return False
    w.set(inv, pow(v, P - 2, P) if v != 0 else 0)
    return True


def _gen_split_le(w, t, bits):
    v = w.get(t)
    if v is None:
        return False
    for i, bt in enumerate(bits):
        w.set(bt, (v >> i) & 1)
    return True


def _gen_poseidon(w, row, inputs, swap_t, outs):
    from .gates import PoseidonGate

    vals = [w.get(t) for t in inputs]
    sv = w.get(swap_t)
    if any(v is None for v in vals) or sv is None:
        return False
    row_vals = PoseidonGate.fill_row(vals, sv)
    for col, v in row_vals.items():
        if col >= PoseidonGate.W_DELTA:  # non-routed intermediates
            w.set_wire(row, col, v)
    for i in range(12):
        w.set(outs[i], row_vals[PoseidonGate.W_OUT + i])
    return True


def _gen_u32_mul_add(w, a, b, c, row, op, out_lo, out_hi):
    from .gates import U32MulAddGate

    va, vb, vc = w.get(a), w.get(b), w.get(c)
    if va is None or vb is None or vc is None:
        return False
    lo, hi, chunks, u = U32MulAddGate.fill_op(va, vb, vc)
    w.set(out_lo, lo)
    w.set(out_hi, hi)
    for k, ch in enumerate(chunks):
        w.set_wire(row, U32MulAddGate.CHUNK_BASE + 32 * op + k, ch)
    w.set_wire(row, U32MulAddGate.INV_BASE + op, u)
    return True


def _gen_ext_inverse(w, x0, x1, inv0, inv1, w_ext):
    """Extension-field inverse witness: (x0 + x1*X)^-1 over X^2 = w_ext."""
    v0, v1 = w.get(x0), w.get(x1)
    if v0 is None or v1 is None:
        return False
    norm = (v0 * v0 - w_ext * v1 * v1) % P
    ninv = pow(norm, P - 2, P)
    w.set(inv0, v0 * ninv % P)
    w.set(inv1, (-v1) * ninv % P)
    return True


register_generator_kind("arith", _gen_arithmetic)
register_generator_kind("inv_or_zero", _gen_inverse_or_zero)
register_generator_kind("split_le", _gen_split_le)
register_generator_kind("poseidon", _gen_poseidon)
register_generator_kind("u32_mul_add", _gen_u32_mul_add)
register_generator_kind("ext_inverse", _gen_ext_inverse)
