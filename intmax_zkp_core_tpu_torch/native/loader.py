"""Build and load the host C++ of the port: the Poseidon permutation and the
witness-generation engine.

Each source is compiled with ``g++ -O3 -march=native -shared -fPIC`` at first
use into the package's git-ignored ``_build/`` directory (beside the CUDA
library) and loaded with ``ctypes``.  The file name carries a tag hashed from
the source, the flags and the host CPU's model name, so a ``_build/``
directory carried to another machine never loads a library built for other
instructions.  The compiler writes to a temporary file that is then renamed
into place, so processes that build at the same time do not collide.

A failed build raises ``RuntimeError`` with the compiler's message: no caller
carries on without the library.  The round constants, the MDS matrix and the
sparse partial-round tables are handed to the library at load time from the
package's own tables (``ops/poseidon.py``, ``ops/poseidon_constants.py``,
``ops/poseidon_fast.py``); none is typed into a source.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
import time

import numpy as np

_HERE = os.path.dirname(os.path.abspath(__file__))
BUILD_DIR = os.path.join(os.path.dirname(_HERE), "_build")
CXX = "g++"
CXX_FLAGS = ["-O3", "-march=native", "-shared", "-fPIC"]
SOURCES = {
    "poseidon": os.path.join(_HERE, "poseidon_native.cpp"),
    "witness": os.path.join(_HERE, "witness_native.cpp"),
}

_libs: dict = {}
_lock = threading.Lock()
# seconds each library took to build in this process (0.0: it was on disk)
BUILD_SECONDS: dict = {}

_U64P = ctypes.POINTER(ctypes.c_uint64)
_I64P = ctypes.POINTER(ctypes.c_int64)
_U8P = ctypes.POINTER(ctypes.c_uint8)


def _cpu_model() -> str:
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                if line.startswith("model name"):
                    return line.split(":", 1)[1].strip()
    except OSError:
        pass
    return os.uname().machine


def library_path(name: str) -> str:
    """Where the library of source ``name`` lives once built."""
    with open(SOURCES[name], "rb") as f:
        src = f.read()
    tag = hashlib.sha256(
        src + b"\0" + " ".join(CXX_FLAGS).encode() + b"\0" + _cpu_model().encode()
    ).hexdigest()[:16]
    return os.path.join(BUILD_DIR, f"{name}_native_{tag}.so")


def _build(name: str) -> str:
    path = library_path(name)
    if os.path.exists(path):
        BUILD_SECONDS.setdefault(name, 0.0)
        return path
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{path}.tmp{os.getpid()}"
    cmd = [CXX, *CXX_FLAGS, SOURCES[name], "-o", tmp]
    t0 = time.perf_counter()
    try:
        res = subprocess.run(cmd, capture_output=True, text=True)
    except OSError as e:
        raise RuntimeError(f"building {SOURCES[name]} failed: {' '.join(cmd)}: {e}") from e
    if res.returncode != 0:
        raise RuntimeError(
            f"building {SOURCES[name]} failed ({' '.join(cmd)}, exit {res.returncode}):\n"
            f"{res.stderr}"
        )
    os.replace(tmp, path)
    BUILD_SECONDS[name] = time.perf_counter() - t0
    return path


def _init_poseidon(lib) -> None:
    from ..ops.poseidon import _MDS_INT
    from ..ops.poseidon_constants import ALL_ROUND_CONSTANTS

    lib.poseidon_init.argtypes = [_U64P, _U64P]
    lib.poseidon_permute_batch.argtypes = [_U64P, ctypes.c_int64]
    lib.poseidon_hash_no_pad.argtypes = [_U64P, ctypes.c_int64, _U64P]
    for fn in (lib.poseidon_init, lib.poseidon_permute_batch, lib.poseidon_hash_no_pad):
        fn.restype = None
    rc = np.array(ALL_ROUND_CONSTANTS, dtype=np.uint64)
    mds = np.array(_MDS_INT, dtype=np.uint64).reshape(-1)
    lib.poseidon_init(rc.ctypes.data_as(_U64P), mds.ctypes.data_as(_U64P))


def _init_witness(lib) -> None:
    from ..ops.poseidon import _MDS_INT
    from ..ops.poseidon_constants import ALL_ROUND_CONSTANTS
    from ..ops.poseidon_fast import PARTIAL_A, PARTIAL_B

    lib.witness_init.argtypes = [_U64P, _U64P, _U64P, _U64P]
    lib.witness_init.restype = None
    lib.witness_run.argtypes = [
        ctypes.c_int64, _I64P, _U64P, _U8P,
        _U64P, ctypes.c_int64, _I64P,
        _U8P,
        _I64P, _I64P, _U64P,
        _I64P, _I64P,
    ]
    lib.witness_run.restype = ctypes.c_int64
    rc = np.array(ALL_ROUND_CONSTANTS, dtype=np.uint64)
    mds = np.array(_MDS_INT, dtype=np.uint64).reshape(-1)
    pa = np.array(PARTIAL_A, dtype=np.uint64).reshape(-1)
    pb = np.array(PARTIAL_B, dtype=np.uint64).reshape(-1)
    assert pa.shape == (22 * 35,) and pb.shape == (12 * 35,)
    lib.witness_init(*(a.ctypes.data_as(_U64P) for a in (rc, mds, pa, pb)))


_INIT = {"poseidon": _init_poseidon, "witness": _init_witness}


def load(name: str):
    """The loaded library of source ``name`` (``"poseidon"`` or
    ``"witness"``), built first if it is not on disk."""
    lib = _libs.get(name)
    if lib is not None:
        return lib
    with _lock:
        if name not in _libs:
            lib = ctypes.CDLL(_build(name))
            _INIT[name](lib)
            _libs[name] = lib
    return _libs[name]


def witness_lib():
    return load("witness")


def native_permute_batch(states) -> np.ndarray:
    """[n, 12] u64 states -> their permuted copy."""
    buf = np.array(states, dtype=np.uint64, order="C")
    if buf.ndim != 2 or buf.shape[1] != 12:
        raise ValueError(f"expected [n, 12] states, got shape {buf.shape}")
    load("poseidon").poseidon_permute_batch(buf.ctypes.data_as(_U64P), buf.shape[0])
    return buf


def native_hash_no_pad(inputs) -> tuple:
    """u64 sponge input (rate 8, no padding) -> the 4-limb digest."""
    arr = np.array(inputs, dtype=np.uint64)
    if arr.ndim != 1:
        raise ValueError(f"expected a flat input, got shape {arr.shape}")
    out = np.zeros(4, dtype=np.uint64)
    load("poseidon").poseidon_hash_no_pad(arr.ctypes.data_as(_U64P), arr.shape[0],
                                        out.ctypes.data_as(_U64P))
    return tuple(int(x) for x in out)
