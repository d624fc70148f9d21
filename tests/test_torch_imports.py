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
        "ops/merkle.py", "ops/poseidon_constants.py", "ops/poseidon_fast.py",
        "utils/hash_out.py", "utils/poseidon_host.py", "engine/config.py",
        "engine/witness.py", "engine/generators.py", "engine/challenger.py",
        "engine/algebra.py", "engine/gates.py", "engine/circuit.py", "engine/fri.py",
        "engine/prover.py", "engine/verifier.py", "engine/serde.py", "engine/carry.py",
        "models/zkdsa/circuits.py",
    ):
        assert want in have, want
    assert (PORT / "csrc" / "poseidon.cu").is_file()
    assert (PORT / "csrc" / "goldilocks.cuh").is_file()


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_import(path):
    for mod in _imported_modules(path):
        top = mod.split(".")[0]
        assert top not in FORBIDDEN, f"{path.relative_to(ROOT)} imports {mod}"
