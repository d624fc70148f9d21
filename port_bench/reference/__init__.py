"""The benchmark's plain reference: Poseidon, the sparse Merkle tree and the
proof verifier in Python integers.  It imports nothing of the program."""
