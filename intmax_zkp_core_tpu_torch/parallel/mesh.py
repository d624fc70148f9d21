"""Device meshes, the active commit mesh and the multi-process entry point.

A ``Mesh`` is an ordered tuple of this process's devices along one axis,
and, when it comes from ``init_distributed``, the number of processes that
each hold such a tuple: the axis then runs over every process's devices in
rank order (shard ``process_index * len(devices) + i`` is this process's
``devices[i]``: ``Mesh.first`` is the first of them), and ``mesh.size``
counts them all.  A device may appear more than once; its shards then take
turns on it.  That is how one card (or the CPU) holds a mesh of d > 1
shards, as the JAX package's tests get d > 1 from virtual CPU devices.

Two axes use a mesh:

* the proof axis: ``engine/prover.py::prove_batch(..., mesh=)`` splits K
  proofs over the mesh's devices and processes;
* the intra-op axis: inside ``use_commit_mesh``, the prover's commitments
  compute every LDE of at least ``min_lde`` points with the four-step NTT
  sharded over the mesh (``parallel/ntt_sharded.py``) and hash their Merkle
  trees shard by shard (``parallel/merkle_sharded.py``).  Over several
  processes every process runs the same program on the same data (SPMD, as
  the JAX package's multi-host mesh): each computes its own shards, the
  exchanges cross processes through ``torch.distributed`` (``exchange``)
  and every process assembles the whole value (``gather``).

Results are bit-identical to one device's either way: the arithmetic is
exact mod p and the transcript deterministic.

A sharded value is a tuple of this process's parts, part i (shard
``mesh.first + i``) on ``mesh.devices[i]``, whose concatenation over every
process along the sharded axis is the whole (``gather``).

How the exchanges cross processes (``exchange_route``), chosen from the mesh
and the process group, never by trying a collective:

* NCCL, where every rank's shards are CUDA devices and no card serves two
  ranks: a process group of its own beside the gloo group that
  ``init_distributed`` makes, its tensors on each rank's first device;
* gloo otherwise (CPU shards, or ranks that share a card, which NCCL
  refuses): the blocks are staged through host memory.
"""

from __future__ import annotations

import time
from contextlib import contextmanager
from dataclasses import dataclass

import torch
import torch.distributed as dist

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

    @property
    def first(self) -> int:
        """The axis index of this process's first shard."""
        return self.process_index * len(self.devices)


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
    """This process's devices of ``mesh``, in order: those of the shards
    ``mesh.first`` onwards."""
    return mesh.devices


@dataclass(frozen=True)
class Route:
    """How a mesh's exchanges cross processes: ``backend`` "local" (one
    process), "gloo" or "nccl", the process ``group`` of its collectives
    (``None``: the default group) and the ``device`` its tensors lie on."""

    backend: str
    group: object
    device: torch.device


_ROUTES: dict = {}  # (mesh, default group) -> Route
_NCCL_GROUPS: dict = {}  # default group -> the NCCL group made beside it

# what crossed processes: collectives, bytes this rank sent, seconds
EXCHANGE_STATS = {"collectives": 0, "bytes": 0, "seconds": 0.0}


def _cards(devices) -> frozenset | None:
    """The CUDA cards (by UUID) under ``devices``, or ``None`` if one is not
    a CUDA device."""
    if any(d.type != "cuda" for d in devices):
        return None
    return frozenset(str(torch.cuda.get_device_properties(d).uuid) for d in devices)


def exchange_route(mesh: Mesh) -> Route:
    """The route of ``mesh``'s exchanges across processes (the module's
    rule): NCCL where every rank's shards are CUDA devices, no card serves
    two ranks and PyTorch has NCCL; gloo otherwise, through host memory.
    One process: "local".  The first call for a mesh is a collective (each
    rank's cards are gathered), so every rank makes it at the same point:
    ``use_commit_mesh`` does, on entry.  Raises ``RuntimeError`` for a mesh
    over processes without their process group."""
    if mesh.process_count == 1:
        return Route("local", None, mesh.devices[0])
    if not dist.is_initialized():
        raise RuntimeError(f"a mesh over {mesh.process_count} processes needs their process "
                           "group: call init_distributed first")
    if (dist.get_world_size(), dist.get_rank()) != (mesh.process_count, mesh.process_index):
        raise RuntimeError(f"the mesh is process {mesh.process_index} of {mesh.process_count}, "
                           f"the group rank {dist.get_rank()} of {dist.get_world_size()}")
    world = dist.group.WORLD
    key = (mesh, world)
    if key not in _ROUTES:
        every = [None] * mesh.process_count
        dist.all_gather_object(every, _cards(mesh.devices))
        distinct = all(c is not None for c in every) and (
            len(frozenset().union(*every)) == sum(len(c) for c in every))
        if distinct and dist.is_nccl_available():
            if world not in _NCCL_GROUPS:
                _NCCL_GROUPS[world] = dist.new_group(backend="nccl")
            _ROUTES[key] = Route("nccl", _NCCL_GROUPS[world], mesh.devices[0])
        else:
            _ROUTES[key] = Route("gloo", None, torch.device("cpu"))
    return _ROUTES[key]


def _collective_done(route: Route, t0: float, sent: torch.Tensor) -> None:
    """Count a collective in ``EXCHANGE_STATS`` (its end awaited on the card
    for NCCL, whose collectives the host does not wait for)."""
    if route.device.type == "cuda":
        torch.cuda.synchronize(route.device)
    EXCHANGE_STATS["collectives"] += 1
    EXCHANGE_STATS["bytes"] += sent.numel() * sent.element_size()
    EXCHANGE_STATS["seconds"] += time.perf_counter() - t0


def exchange(blocks, mesh: Mesh) -> list:
    """The all-to-all of the sharded NTT: ``blocks[i][g]`` is the block this
    process's shard i sends to shard g of the mesh (every block of one shape
    and type); returns ``recv[j][g]``, the block its shard j gets from shard
    g, on ``mesh.devices[j]``.  Between this process's shards a copy (none
    where both sit on one device); across processes one collective
    (``all_to_all_single`` over ``exchange_route``), for which each process
    packs, per destination process, the blocks its shards send there."""
    devices = mesh.devices
    L, first, P, me = len(devices), mesh.first, mesh.process_count, mesh.process_index
    recv = [[None] * mesh.size for _ in devices]
    for j, dev in enumerate(devices):
        for i in range(L):
            recv[j][first + i] = blocks[i][first + j].to(dev)
    if P == 1:
        return recv
    route = exchange_route(mesh)
    t0 = time.perf_counter()
    # (other process, sending shard, receiving shard): the order every process packs and unpacks
    pairs = [(q, i, j) for q in range(P) if q != me for i in range(L) for j in range(L)]
    send = torch.stack([blocks[i][q * L + j].to(route.device) for q, i, j in pairs])
    got = torch.empty_like(send)
    splits = [0 if q == me else L * L for q in range(P)]
    dist.all_to_all_single(got, send, splits, splits, group=route.group)
    for (q, i, j), block in zip(pairs, got):
        recv[j][q * L + i] = block.to(devices[j])
    _collective_done(route, t0, send)
    return recv


def gather(parts, dim: int, device, mesh: Mesh | None = None) -> torch.Tensor:
    """A sharded value's parts, concatenated along ``dim`` on ``device``.
    With a mesh over several processes, ``parts`` are this process's and
    every rank gets the whole value (the JAX package's
    ``process_allgather(tiled=True)``): one ``all_gather`` of each
    process's concatenation over ``exchange_route``, then the processes'
    pieces in rank order."""
    device = torch.device(device)
    if mesh is None or mesh.process_count == 1:
        return torch.cat([p.to(device) for p in parts], dim=dim)
    route = exchange_route(mesh)
    t0 = time.perf_counter()
    mine = torch.cat([p.to(route.device) for p in parts], dim=dim).contiguous()
    every = [torch.empty_like(mine) for _ in range(mesh.process_count)]
    dist.all_gather(every, mine, group=route.group)
    whole = torch.cat([t.to(device) for t in every], dim=dim)
    _collective_done(route, t0, mine)
    return whole


def init_distributed(coordinator_address: str | None = None,
                     num_processes: int | None = None,
                     process_id: int | None = None,
                     devices=None) -> Mesh:
    """Join (or start) a ``torch.distributed`` process group and return the
    mesh of the proof axis over every process's local devices.

    ``coordinator_address`` ("host:port") names the rank-0 rendezvous; the
    group uses gloo, since the proof axis gathers proofs as host objects; a
    commit mesh over cards that no two ranks share makes an NCCL group beside
    it for its exchanges (``exchange_route``).
    ``devices`` are this process's devices on the axis (``None``: every CUDA
    device, raising without one); every process must give as many.

    A call that names a coordinator and fails raises.  A call that finds a
    group already running joins nothing and returns the mesh over it.  A
    single process with no coordinator gets its local mesh."""
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
    tree, each where its length allows the split).  A mesh over several
    processes (``init_distributed``) is entered by every rank at once: its
    exchange route is chosen here (``exchange_route``)."""
    global _COMMIT
    check_axis(axis_name)
    exchange_route(mesh)
    prev = _COMMIT
    _COMMIT = CommitMesh(mesh, min_lde)
    try:
        yield
    finally:
        _COMMIT = prev
