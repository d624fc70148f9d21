"""Compute functions: Goldilocks field, Poseidon, NTT, Merkle hashing."""
