"""Multi-device execution: device meshes and the multi-process entry point
(``mesh.py``), the NTT sharded by the four-step algorithm
(``ntt_sharded.py``), Merkle trees hashed shard by shard
(``merkle_sharded.py``), a distributed proving step (``prove_step.py``) and
proving many witnesses of one circuit, with the proof axis over a mesh
(``aggregate.py``).  The counterpart of the JAX package's ``parallel/``."""

from .mesh import Mesh, init_distributed, make_mesh, use_commit_mesh  # noqa: F401
from .ntt_sharded import ntt_sharded  # noqa: F401


def __getattr__(name):
    # ``prove_many`` sits on the prover, which imports this package's mesh
    # modules: it is imported when first asked for, not with the package
    if name == "prove_many":
        from .aggregate import prove_many

        return prove_many
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
