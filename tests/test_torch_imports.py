"""The port stands alone: no file of ``intmax_zkp_core_tpu_torch`` and not
``chip_smoke.py`` imports ``jax`` or anything of ``intmax_zkp_core_tpu``.

An ``ast`` scan of the sources (``sys.modules`` would say nothing: the test
process itself imports jax)."""

import ast
import pathlib

import pytest

ROOT = pathlib.Path(__file__).resolve().parent.parent
PORT = ROOT / "intmax_zkp_core_tpu_torch"
FILES = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]
FORBIDDEN = ("jax", "jaxlib", "intmax_zkp_core_tpu")


def _imported_modules(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module
        elif (
            isinstance(node, ast.Call)
            and getattr(node.func, "id", getattr(node.func, "attr", "")) in ("__import__", "import_module")
            and node.args
            and isinstance(node.args[0], ast.Constant)
            and isinstance(node.args[0].value, str)
        ):
            yield node.args[0].value


def test_port_has_its_modules():
    have = {str(p.relative_to(PORT)) for p in FILES[:-1]}
    for want in (
        "ops/goldilocks.py", "ops/poseidon.py", "ops/poseidon_cuda.py", "ops/ntt.py",
        "ops/cuda_build.py", "ops/perm_columns_cuda.py", "ops/perm_quotient_cuda.py",
        "ops/zinv_mul_cuda.py", "ops/fri_init_cuda.py", "ops/gate_quotient_cuda.py",
        "ops/ntt_cuda.py",
        "ops/merkle.py", "ops/poseidon_constants.py", "ops/poseidon_fast.py",
        "utils/hash_out.py", "utils/poseidon_host.py", "engine/config.py",
        "engine/witness.py", "engine/generators.py", "engine/challenger.py",
        "engine/algebra.py", "engine/gates.py", "engine/circuit.py", "engine/fri.py",
        "engine/prover.py", "engine/verifier.py", "engine/serde.py", "engine/carry.py",
        "models/zkdsa/circuits.py",
        "native/__init__.py", "native/loader.py", "native/witness.py",
        "models/merkle_tree/__init__.py", "models/merkle_tree/tree.py",
        "models/merkle_tree/gadgets.py", "models/sparse_merkle_tree/__init__.py",
        "models/sparse_merkle_tree/node_data.py", "models/sparse_merkle_tree/proofs.py",
        "models/sparse_merkle_tree/tree.py", "models/sparse_merkle_tree/layered.py",
        "models/sparse_merkle_tree/storage_layout.py",
        "models/sparse_merkle_tree/gadgets/__init__.py",
        "models/sparse_merkle_tree/gadgets/common.py",
        "models/sparse_merkle_tree/gadgets/verify.py",
        "models/sparse_merkle_tree/gadgets/process.py",
        "bin/__init__.py", "bin/verify_smt_process.py", "bin/smt_verifier.py",
        "config.py", "engine/batch_prover.py", "parallel/__init__.py", "parallel/aggregate.py",
        "models/transaction/__init__.py", "models/transaction/block_header.py",
        "models/transaction/user_asset_tree.py", "models/transaction/circuits.py",
        "models/transaction/gadgets/__init__.py", "models/transaction/gadgets/utils.py",
        "models/transaction/gadgets/asset_mess.py", "models/transaction/gadgets/block_header.py",
        "models/transaction/gadgets/purge.py", "models/transaction/gadgets/merge.py",
        "models/rollup/__init__.py", "models/rollup/block_flow.py",
        "models/transaction/asset.py", "engine/recursion.py", "models/recursion/__init__.py",
        "models/recursion/gadgets.py", "models/rollup/address_list.py",
        "models/rollup/deposit.py", "models/rollup/block.py", "models/rollup/circuits.py",
        "models/rollup/mini_block.py", "models/rollup/gadgets/__init__.py",
        "models/rollup/gadgets/deposit_block.py", "models/rollup/gadgets/block_headers_tree.py",
        "models/rollup/gadgets/proposal_block.py", "models/rollup/gadgets/approval_block.py",
        "models/rollup/gadgets/batch.py", "bin/block_circuit.py",
        "engine/circuit_cache.py", "models/ecdsa/__init__.py", "models/ecdsa/account.py",
        "models/ecdsa/gadgets.py", "models/ecdsa/circuits.py", "bin/ecdsa_verification.py",
        "parallel/mesh.py", "parallel/ntt_sharded.py", "parallel/merkle_sharded.py",
        "parallel/prove_step.py", "runtime.py",
    ):
        assert want in have, want
    # the scan below covers every package directory, bin/ and native/ among them
    assert {p.split("/")[0] for p in have} >= {"ops", "engine", "models", "utils", "bin", "native",
                                               "parallel"}
    for source in ("poseidon_native.cpp", "witness_native.cpp"):
        assert (PORT / "native" / source).is_file(), source
    for source in ("goldilocks.cuh", "poseidon_round.cuh", "runtime.cu", "poseidon.cu",
                   "perm_columns.cu", "perm_quotient.cu", "zinv_mul.cu", "fri_init.cu",
                   "gate_quotient.cu", "ntt.cu"):
        assert (PORT / "csrc" / source).is_file(), source


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_import(path):
    for mod in _imported_modules(path):
        top = mod.split(".")[0]
        assert top not in FORBIDDEN, f"{path.relative_to(ROOT)} imports {mod}"
