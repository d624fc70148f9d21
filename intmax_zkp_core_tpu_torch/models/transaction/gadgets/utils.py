"""is_non_zero gadget: prove some limb of a digest is non-zero via
inverse-or-zero witnesses (reference
``src/transaction/gadgets/utils/mod.rs:19-68``)."""

from __future__ import annotations

from ....engine.circuit import CircuitBuilder, HashOutTarget

P = 0xFFFFFFFF00000001


def is_non_zero(builder: CircuitBuilder, target: HashOutTarget) -> None:
    is_zeros = []
    for e in target:
        inv = builder.add_virtual_target()
        builder.generators.append(("inv_or_zero", e, inv))
        # not_y_times_inv = 1 - y*inv must be 0 or 1
        nyi = builder.arithmetic(P - 1, 1, e, inv, builder.one())
        z = builder.arithmetic(1, P - 1, nyi, nyi, nyi)  # nyi^2 - nyi
        builder.assert_zero(z)
        is_zeros.append(nyi)
    tmp0 = builder.mul(is_zeros[0], is_zeros[1])
    tmp1 = builder.mul(is_zeros[2], is_zeros[3])
    builder.assert_zero(builder.mul(tmp0, tmp1))
