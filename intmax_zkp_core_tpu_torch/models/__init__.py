"""Application layer: the zkDSA signature circuit, a Poseidon hash chain, the dense
Merkle tree and the sparse Merkle tree with their in-circuit gadgets, the
user-transaction layer (``transaction/``), recursive proof wrapping
(``recursion/``) and block production (``rollup/``)."""
