from .tree import MerkleProof, get_merkle_proof, get_merkle_proof_with_zero, get_merkle_root, log2_ceil  # noqa: F401
