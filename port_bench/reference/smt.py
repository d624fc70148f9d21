"""The keyed sparse Merkle tree of the reference's SMT process proofs, as
the set of its leaves: a key's path is the little-endian bits of its digest;
a subtree that holds no leaf hashes to zero, one that holds one leaf is that
leaf, ``hash_pad(key || value || 1)``, and any other is ``two_to_one`` of its
halves.  The root after each ``set`` is all a process proof states about the
tree (its old and new roots are the circuit's public inputs)."""

from __future__ import annotations

import bisect

from .poseidon import hash_pad, two_to_one

ZERO = (0, 0, 0, 0)
KEY_BITS = 256


def digest(key) -> tuple:
    """A key as its digest: an int k stands for (k, 0, 0, 0)."""
    return (int(key), 0, 0, 0) if isinstance(key, int) else tuple(int(x) for x in key)


def _path(key) -> int:
    """The key's path: the little-endian bits of its four elements in turn,
    the first bit highest, so that a subtree is a range of the sorted
    paths."""
    return int("".join(f"{e:064b}"[::-1] for e in digest(key)), 2)


class SparseMerkleTree:
    def __init__(self):
        self.values: dict = {}  # key digest -> 4-element value
        self.paths: list = []  # sorted paths of the keys held
        self.by_path: dict = {}
        self.memo: dict = {}  # (level, prefix) -> digest

    def _node(self, level: int, prefix: int) -> tuple:
        found = self.memo.get((level, prefix))
        if found is not None:
            return found
        span = KEY_BITS - level
        lo = bisect.bisect_left(self.paths, prefix << span)
        hi = bisect.bisect_left(self.paths, (prefix + 1) << span)
        if hi == lo:
            h = ZERO
        elif hi - lo == 1:
            key = self.by_path[self.paths[lo]]
            h = hash_pad([*key, *self.values[key], 1])
        else:
            h = two_to_one(self._node(level + 1, 2 * prefix), self._node(level + 1, 2 * prefix + 1))
        self.memo[(level, prefix)] = h
        return h

    def root(self) -> tuple:
        return self._node(0, 0)

    def get(self, key) -> tuple:
        return self.values.get(digest(key), ZERO)

    def set(self, key, value) -> tuple:
        """Set (or, with a zero value, remove) ``key`` (an int k for the
        digest (k, 0, 0, 0), or a digest); the new root."""
        key = digest(key)
        value = tuple(int(v) for v in value)
        path = _path(key)
        for level in range(KEY_BITS + 1):
            self.memo.pop((level, path >> (KEY_BITS - level)), None)
        if key in self.values:
            if value == ZERO:
                del self.values[key]
                self.paths.remove(path)
                del self.by_path[path]
            else:
                self.values[key] = value
        elif value != ZERO:
            self.values[key] = value
            bisect.insort(self.paths, path)
            self.by_path[path] = key
        return self.root()
