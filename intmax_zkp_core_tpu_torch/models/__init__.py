"""Application layer (so far: the zkDSA signature circuit and a Poseidon hash chain)."""
