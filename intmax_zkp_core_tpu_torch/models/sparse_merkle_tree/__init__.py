from .node_data import Node, NodeDataMemory, RootDataMemory, RootDataTmp  # noqa: F401
from .proofs import (  # noqa: F401
    ProcessMerkleProofRole,
    SparseMerkleInclusionProof,
    SparseMerkleProcessProof,
    first_different_bit_index,
    smt_lev_ins,
    verify_smt_process_proof,
)
from .tree import SparseMerkleTree, key_to_bits  # noqa: F401
from .layered import (  # noqa: F401
    LayeredSparseMerkleTree,
    LayeredLayeredSparseMerkleTree,
    verify_layered_smt_connection,
)
