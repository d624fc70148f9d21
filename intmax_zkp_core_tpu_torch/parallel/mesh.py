"""Device meshes, the active commit mesh and the multi-process entry point.

A ``Mesh`` is an ordered tuple of this process's devices along one axis,
and, when it comes from ``init_distributed``, the number of processes that
each hold such a tuple: the axis then runs over every process's devices in
rank order, and ``mesh.size`` counts them all.  A device may appear more
than once; its shards then take turns on it.  That is how one card (or the
CPU) holds a mesh of d > 1 shards, as the JAX package's tests get d > 1 from
virtual CPU devices.

Two axes use a mesh:

* the proof axis: ``engine/prover.py::prove_batch(..., mesh=)`` splits K
  proofs over the mesh's devices and processes;
* the intra-op axis: inside ``use_commit_mesh``, the prover's commitments
  compute every LDE of at least ``min_lde`` points with the four-step NTT
  sharded over the mesh (``parallel/ntt_sharded.py``) and hash their Merkle
  trees shard by shard (``parallel/merkle_sharded.py``).  This mesh is local
  to a process.

Results are bit-identical to one device's either way: the arithmetic is
exact mod p and the transcript deterministic.

A sharded value is a tuple of parts, part i on ``mesh.devices[i]``, whose
concatenation along the sharded axis is the whole (``gather``).
"""

from __future__ import annotations

from contextlib import contextmanager
from dataclasses import dataclass

import torch

# LDEs at least this long go through the sharded four-step NTT when a commit
# mesh is active; below it the exchanges cost more than the split saves
# (the JAX package's ``engine/prover.py::SHARD_COMMIT_MIN_LDE``).
SHARD_COMMIT_MIN_LDE = 1 << 17


# The name of a mesh's one axis, as the JAX package's meshes call it; the
# two calls that take an axis name for parity with the JAX package
# (``use_commit_mesh``, ``prove_batch``) accept only this one.
AXIS = "d"


def check_axis(axis_name: str) -> None:
    """Raise ``KeyError`` for an axis name other than ``AXIS`` (as a JAX
    mesh does for an axis it lacks)."""
    if axis_name != AXIS:
        raise KeyError(f"a mesh has one axis, {AXIS!r}, not {axis_name!r}")


@dataclass(frozen=True)
class Mesh:
    """One axis over ``devices`` (this process's, in order), repeated over
    ``process_count`` processes of which this is ``process_index``."""

    devices: tuple
    process_count: int = 1
    process_index: int = 0

    def __post_init__(self):
        devices = tuple(torch.device(d) for d in self.devices)
        if not devices:
            raise ValueError("a mesh needs at least one device")
        if not 0 <= self.process_index < self.process_count:
            raise ValueError(f"process {self.process_index} of {self.process_count}")
        object.__setattr__(self, "devices", devices)

    @property
    def size(self) -> int:
        """Shards along the axis, over every process."""
        return len(self.devices) * self.process_count


def make_mesh(n_devices: int | None = None) -> Mesh:
    """A mesh over the first ``n_devices`` CUDA devices (all of them for
    ``None``).  Raises when there are fewer, or none: it never takes the CPU
    (build ``Mesh(["cpu"] * d)`` for that)."""
    have = torch.cuda.device_count() if torch.cuda.is_available() else 0
    n = have if n_devices is None else n_devices
    if have == 0 or n < 1 or n > have:
        raise RuntimeError(f"make_mesh needs {n} CUDA device(s), this process sees {have}")
    return Mesh(tuple(torch.device("cuda", i) for i in range(n)))


def default_mesh(device, k: int) -> Mesh | None:
    """The proof axis's mesh for a batch of ``k`` proofs where the caller
    gives none (the JAX package's rule for its flows and ``prove_many``):
    every CUDA device when k > 1, ``device`` is a CUDA device (``None``: the
    CUDA default) and more than one is attached; ``None`` otherwise."""
    if k < 2 or (device is not None and torch.device(device).type != "cuda"):
        return None
    if not torch.cuda.is_available() or torch.cuda.device_count() < 2:
        return None
    return make_mesh()


def local_devices(mesh: Mesh) -> tuple:
    """The devices of ``mesh`` for work that runs within one process (a
    sharded NTT or tree, the commit mesh).  Raises ``ValueError`` for a mesh
    that spans processes."""
    if mesh.process_count != 1:
        raise ValueError("a sharded NTT, tree or commit runs over one process's devices; "
                         f"this mesh spans {mesh.process_count} processes")
    return mesh.devices


def gather(parts, dim: int, device) -> torch.Tensor:
    """A sharded value's parts, concatenated along ``dim`` on ``device``."""
    device = torch.device(device)
    return torch.cat([p.to(device) for p in parts], dim=dim)


def init_distributed(coordinator_address: str | None = None,
                     num_processes: int | None = None,
                     process_id: int | None = None,
                     devices=None) -> Mesh:
    """Join (or start) a ``torch.distributed`` process group and return the
    mesh of the proof axis over every process's local devices.

    ``coordinator_address`` ("host:port") names the rank-0 rendezvous; the
    group uses gloo, since the proof axis gathers proofs as host objects.
    ``devices`` are this process's devices on the axis (``None``: every CUDA
    device, raising without one); every process must give as many.

    A call that names a coordinator and fails raises.  A call that finds a
    group already running joins nothing and returns the mesh over it.  A
    single process with no coordinator gets its local mesh."""
    import torch.distributed as dist

    local = make_mesh().devices if devices is None else tuple(devices)
    if not dist.is_initialized() and coordinator_address is not None:
        dist.init_process_group(
            "gloo", init_method=f"tcp://{coordinator_address}",
            world_size=num_processes, rank=process_id,
        )
    if not dist.is_initialized():
        return Mesh(local)
    return Mesh(local, process_count=dist.get_world_size(), process_index=dist.get_rank())


@dataclass(frozen=True)
class CommitMesh:
    mesh: Mesh | None
    min_lde: int


_COMMIT = CommitMesh(None, SHARD_COMMIT_MIN_LDE)


def commit_mesh() -> CommitMesh:
    """The mesh the prover's commitments shard over and the shortest LDE
    sharded; the mesh is ``None`` outside ``use_commit_mesh``."""
    return _COMMIT


@contextmanager
def use_commit_mesh(mesh: Mesh, axis_name: str = AXIS, min_lde: int = SHARD_COMMIT_MIN_LDE):
    """Inside the context, every commitment whose LDE has at least
    ``min_lde`` points is computed over ``mesh`` (the LDE and the Merkle
    tree, each where its length allows the split).  ``mesh`` must be local
    to this process."""
    global _COMMIT
    check_axis(axis_name)
    local_devices(mesh)
    prev = _COMMIT
    _COMMIT = CommitMesh(mesh, min_lde)
    try:
        yield
    finally:
        _COMMIT = prev
