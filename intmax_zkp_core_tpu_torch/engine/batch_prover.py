"""Batched proving, kept at the JAX package's module path:
``prove_batch`` lives in ``engine/prover.py`` beside the parts it uses."""

from .prover import prove_batch  # noqa: F401
