from .common import (  # noqa: F401
    calc_internal_hash,
    calc_leaf_hash,
    conditionally_reverse,
    conditionally_select,
    enforce_equal_if_enabled,
    enforce_not_equal_if_enabled,
    is_equal_hash_out,
    smt_lev_ins_t,
)
from .process import SparseMerkleProcessProofTarget, get_process_merkle_proof_role  # noqa: F401
from .verify import SparseMerkleInclusionProofTarget  # noqa: F401
