"""Host-side Poseidon hashing over ``HashOut`` values.

Witness generation (SMT updates, block assembly) is pointer-chasing host
logic; bulk hashing (tree builds, prover commitments) uses the batched
device functions in ``ops.poseidon``.  The scalar permutations here are the
exact Python implementation (``ops.poseidon.*_s``); a small cache keeps the
ubiquitous zero-subtree chains free.
"""

from __future__ import annotations

from functools import lru_cache

from ..ops import poseidon as ps
from .hash_out import HashOut


def _hash_no_pad_ints(inputs: tuple) -> tuple:
    return tuple(ps.hash_no_pad_s(list(inputs)))


@lru_cache(maxsize=1 << 16)
def _two_to_one_cached(left: tuple, right: tuple) -> tuple:
    return _hash_no_pad_ints(left + right)


def two_to_one(left: HashOut, right: HashOut) -> HashOut:
    return HashOut(_two_to_one_cached(left.elements, right.elements))


def hash_no_pad(inputs: list[int]) -> HashOut:
    return HashOut(_hash_no_pad_ints(tuple(int(x) for x in inputs)))


def hash_pad(inputs: list[int]) -> HashOut:
    padded = [int(x) for x in inputs] + [1]
    while (len(padded) + 1) % ps.SPONGE_WIDTH != 0:
        padded.append(0)
    padded.append(1)
    return hash_no_pad(padded)


@lru_cache(maxsize=64)
def zero_subtree_root(level: int) -> HashOut:
    """Root of a depth-`level` all-zero-leaf subtree."""
    if level == 0:
        return HashOut.ZERO
    child = zero_subtree_root(level - 1)
    return two_to_one(child, child)
