"""Witness containers and generator execution (plonky2 ``PartialWitness`` +
generator queue)."""

from __future__ import annotations

from ..ops.goldilocks import P_INT

P = P_INT


class PartialWitness:
    """User-provided initial assignments (target -> value)."""

    def __init__(self):
        self.values: dict[int, int] = {}

    def set_target(self, t: int, value: int) -> None:
        self.values[t] = value % P

    def set_bool_target(self, b, value: bool) -> None:
        self.set_target(b.target, int(value))

    def set_hash_target(self, h, digest) -> None:
        for t, v in zip(h, digest):
            self.set_target(t, int(v))


class WitnessFill:
    """Resolves all target classes and non-routed wire values by running
    generators to fixpoint."""

    def __init__(self, prover_data):
        self.pd = prover_data
        self.class_values: dict[int, int] = {}
        self.wire_overrides: dict[tuple[int, int], int] = {}

    def get(self, t: int):
        return self.class_values.get(self.pd.find(t))

    def set(self, t: int, value: int) -> None:
        root = self.pd.find(t)
        value = value % P
        existing = self.class_values.get(root)
        if existing is not None and existing != value:
            raise AssertionError(
                f"conflicting witness values for target {t}: {existing} vs {value}"
            )
        self.class_values[root] = value

    def set_wire(self, row: int, col: int, value: int) -> None:
        self.wire_overrides[(row, col)] = value % P

    def run(self, pw: PartialWitness) -> None:
        for t, v in self.pd.preset_values.items():
            self.set(t, v)
        for t, v in pw.values.items():
            self.set(t, v)
        from .generators import run_generator

        pending = list(self.pd.generators)
        for _ in range(1000):
            still = []
            for gen in pending:
                if not run_generator(self, gen):
                    still.append(gen)
            if not still:
                break
            if len(still) == len(pending):
                raise AssertionError(
                    f"witness generation stuck: {len(still)} generators unresolved"
                )
            pending = still
        else:
            raise AssertionError("witness generation did not converge")
