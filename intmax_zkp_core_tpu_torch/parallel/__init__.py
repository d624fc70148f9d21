"""Proof-level parallelism: proving many independent witnesses of one
circuit (``aggregate.py``).  The multi-device mesh of the JAX package is not
ported yet."""

from .aggregate import prove_many  # noqa: F401
