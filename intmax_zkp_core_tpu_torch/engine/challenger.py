"""Fiat-Shamir transcript: Poseidon duplex sponge (plonky2 ``Challenger``
semantics: buffered observe, duplex on demand, squeeze from the back of the
output buffer).  Host-side scalar — challenge derivation is a handful of
permutations per proof, far off the hot path."""

from __future__ import annotations

from ..ops import poseidon as ps
from ..ops.goldilocks import P_INT

RATE = ps.SPONGE_RATE
WIDTH = ps.SPONGE_WIDTH


class Challenger:
    def __init__(self):
        self.sponge_state = [0] * WIDTH
        self.input_buffer: list[int] = []
        self.output_buffer: list[int] = []

    def observe_element(self, x: int) -> None:
        assert 0 <= x < P_INT
        self.input_buffer.append(x)
        if len(self.input_buffer) == RATE:
            self._duplex()

    def observe_elements(self, xs) -> None:
        for x in xs:
            self.observe_element(int(x))

    def observe_hash(self, digest) -> None:
        self.observe_elements(list(digest))

    def observe_cap(self, cap) -> None:
        for digest in cap:
            self.observe_hash(digest)

    def observe_ext(self, x) -> None:
        self.observe_elements(list(x))

    def _duplex(self) -> None:
        for i, x in enumerate(self.input_buffer):
            self.sponge_state[i] = x
        self.input_buffer.clear()
        self.sponge_state = ps.permute_s(self.sponge_state)
        self.output_buffer = list(self.sponge_state[:RATE])

    def get_challenge(self) -> int:
        if self.input_buffer or not self.output_buffer:
            self._duplex()
        return self.output_buffer.pop()

    def get_n_challenges(self, n: int) -> list[int]:
        return [self.get_challenge() for _ in range(n)]

    def get_extension_challenge(self) -> tuple[int, int]:
        a = self.get_challenge()
        b = self.get_challenge()
        return (a, b)
