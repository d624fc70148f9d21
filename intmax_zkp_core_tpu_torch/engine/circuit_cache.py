"""On-disk circuit cache: build once, reload in any later process.

The reference rebuilds every circuit per process (plonky2 supports
serializing ``CircuitData``; the reference never uses it).  Here a built
circuit object -- the model-layer target structs and the full
``ProverCircuitData`` -- pickles directly (witness generators are
declarative records, ``engine/generators.py``; the tables are numpy), so a
prover pays the constraint emission and the preprocessing once per
(circuit, config) and a later process starts from disk.

``cache_dir=None`` means "build, do not cache"; no environment variable
turns the cache on.  Cache keys must capture everything that changes the
circuit: callers pass a descriptive name plus the config, and the block
flow folds the inner circuits' digests into the name.  The payload is
framed with its sha256, checked on load, so a truncated or corrupted file
raises instead of deserializing garbage.  The format is pickle: this is a
LOCAL build cache (same trust domain as the source tree), never a channel
for circuits from elsewhere -- a verifier never reads it, and a mismatched
circuit yields proofs the verifier rejects.

The device is the caller's: a circuit proves on the device that
``load_or_build`` resolves (``None``: the CUDA device, raising without
one), whatever device wrote the file.  The pickle holds no device and no
torch object (``CircuitData.__getstate__``); ``bind_device`` sets it.

An in-process memo sits on top of the disk: a handful of entries, the
oldest evicted first, each keyed by the file's path, size and mtime_ns, so
a file replaced on disk is read again.
"""

from __future__ import annotations

import hashlib
import os
import pickle
from collections import OrderedDict

from ..ops import goldilocks as gl
from .circuit import CircuitData

_MAGIC = b"IZCT1\n"  # format tag; bump when the framing changes

MEMO_MAX = 4
_MEMO: OrderedDict = OrderedDict()


class CircuitCacheError(ValueError):
    """A cache file that is not a framed circuit or fails its sha256."""


def key_of(name: str, config) -> str:
    fri = config.fri
    return (
        f"{name}-w{config.num_wires}-r{config.num_routed_wires}"
        f"-c{config.num_challenges}-b{fri.rate_bits}-h{fri.cap_height}"
        f"-q{fri.num_query_rounds}-p{fri.proof_of_work_bits}"
    )


def cache_path(cache_dir: str, name: str, config) -> str:
    """The file under ``cache_dir`` that holds the circuit ``name`` at
    ``config``."""
    return os.path.join(os.path.abspath(cache_dir), key_of(name, config) + ".ckt")


def bind_device(circuit, device):
    """Make ``circuit`` (a ``CircuitData`` or an object whose ``.data`` is
    one) build its tables and prove on ``device``."""
    data = circuit if isinstance(circuit, CircuitData) else circuit.data
    data.device = gl.resolve_device(device)
    return circuit


def write_circuit(path: str, circuit) -> int:
    """Write ``circuit`` framed with its sha256 to ``path`` (a temporary
    file, then ``os.replace``); returns the file's size in bytes."""
    payload = pickle.dumps(circuit, protocol=pickle.HIGHEST_PROTOCOL)
    tmp = f"{path}.tmp{os.getpid()}"
    with open(tmp, "wb") as f:
        f.write(_MAGIC)
        f.write(hashlib.sha256(payload).digest())
        f.write(payload)
    os.replace(tmp, path)
    return len(_MAGIC) + 32 + len(payload)


def read_circuit(path: str):
    """The circuit framed in ``path``; raises ``CircuitCacheError`` when the
    file is not framed or its payload fails the sha256."""
    with open(path, "rb") as f:
        magic = f.read(len(_MAGIC))
        stored = f.read(32)
        payload = f.read()
    if magic != _MAGIC:
        raise CircuitCacheError(f"circuit cache file {path} is not a framed circuit")
    if hashlib.sha256(payload).digest() != stored:
        raise CircuitCacheError(
            f"circuit cache file {path} is corrupted (sha256 mismatch); delete it and rebuild"
        )
    return pickle.loads(payload)


def _memo_key(path: str):
    st = os.stat(path)
    return (path, st.st_size, st.st_mtime_ns)


def _remember(key, circuit) -> None:
    _MEMO[key] = circuit
    _MEMO.move_to_end(key)
    while len(_MEMO) > MEMO_MAX:
        _MEMO.popitem(last=False)


def load_or_build(name: str, config, build_fn, cache_dir: str | None = None, device=None):
    """``build_fn(device)``'s result, cached under ``cache_dir`` by a key of
    ``name`` and the circuit config, and bound to ``device`` (``None``: the
    CUDA device, raising without one).  ``build_fn`` must be deterministic;
    its result must be a ``CircuitData`` or expose one as ``.data``.  With
    ``cache_dir=None`` it only builds."""
    device = gl.resolve_device(device)
    if cache_dir is None:
        return build_fn(device)
    os.makedirs(cache_dir, exist_ok=True)
    path = cache_path(cache_dir, name, config)
    if os.path.exists(path):
        key = _memo_key(path)
        circuit = _MEMO.get(key)
        if circuit is None:
            circuit = read_circuit(path)
            _remember(key, circuit)
        return bind_device(circuit, device)
    circuit = build_fn(device)
    write_circuit(path, circuit)
    _remember(_memo_key(path), circuit)
    return bind_device(circuit, device)
