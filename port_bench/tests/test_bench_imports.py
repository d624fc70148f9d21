"""No file of the benchmark imports JAX or the JAX package (top-level module
names compared whole: the port's name begins with the JAX package's), and
the plain reference imports nothing of the port."""

import ast
import glob
import os

from port_bench.harness import cells

FORBIDDEN = {"jax", "jaxlib", "flax", "intmax_zkp_core_tpu"}
PORT = "intmax_zkp_core_tpu_torch"


def imported(path):
    with open(path) as fh:
        tree = ast.parse(fh.read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0]


def files(sub=""):
    return glob.glob(os.path.join(cells.HERE, sub, "**", "*.py"), recursive=True)


def test_no_jax_anywhere():
    found = {(p, m) for p in files() for m in imported(p) if m in FORBIDDEN}
    assert not found


def test_reference_imports_nothing_of_the_program():
    found = {(p, m) for p in files("reference") for m in imported(p)
             if m in FORBIDDEN | {PORT, "port_bench", "torch"}}
    assert not found


def test_whole_names_are_compared():
    assert PORT.split(".")[0] not in FORBIDDEN
