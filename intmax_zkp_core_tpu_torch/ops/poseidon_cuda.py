"""Hand-written CUDA kernels for Poseidon-12 and their PyTorch wrappers.

Two kernels, both in ``csrc/poseidon.cu`` over ``csrc/goldilocks.cuh``:

* ``permute_cuda(states)``  [..., 12] -> [..., 12].  Replaces the JAX
  package's ``ops/poseidon_pallas.py::permute_pallas``.
* ``hash_no_pad_cuda(inputs)``  [B, width >= 1] -> [B, 4], the whole rate-8
  overwrite-absorb sponge in one launch.  Replaces
  ``ops/poseidon_pallas.py::hash_no_pad_pallas``.  It takes the strides of
  its input, so a transposed ``[width, B]`` matrix (an LDE handed over as
  ``lde.t()``) is hashed without materializing the transpose, and
  neighbouring threads read neighbouring addresses.

Design: one thread per permutation, state in 64-bit registers, grid-stride
loop, constants in ``__constant__`` memory; any batch size >= 1.

What bounds them on the card: a permutation moves 192 bytes but needs about
6.4 thousand 32-bit integer multiply-adds even in the cheapest known
formulation (the sparse partial rounds of ``ops/poseidon_fast.py``), so the
integer pipe — not memory — is the limit.  These kernels use the dense
formulation (118 S-boxes of four 64x64->128 multiplies, 30 MDS layers of 290
small multiplies: about 10.6 thousand).  ``chip_smoke.py`` prints measured
times beside the bound of the cheapest formulation.

The plain PyTorch versions are ``permute`` and ``hash_no_pad`` of
``ops/poseidon.py`` (re-exported below as ``permute_plain`` /
``hash_no_pad_plain``).  A wrapper takes the plain version only for a tensor
that lies on the CPU; for a CUDA tensor it launches its kernel or raises.

Build: ``nvcc`` compiles ``csrc/poseidon.cu`` for ``sm_90a`` into a shared
library with a plain C interface under ``_build/`` at first use, loaded with
``ctypes``.  A build failure is an exception.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import time

import torch

from .poseidon import hash_n_to_m_no_pad as _hash_n_to_m_no_pad
from .poseidon import permute as permute_plain
from .poseidon_constants import (
    ALL_ROUND_CONSTANTS,
    MDS_MATRIX_CIRC,
    MDS_MATRIX_DIAG,
    SPONGE_WIDTH,
)

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(_PKG_DIR, "csrc")
BUILD_DIR = os.path.join(_PKG_DIR, "_build")
SOURCE = os.path.join(CSRC_DIR, "poseidon.cu")
LIBRARY = os.path.join(BUILD_DIR, "libposeidon.so")

NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
]

# Launch counts: each wrapper adds one where it launches its kernel, and
# nowhere else.
LAUNCHES = {"permute_cuda": 0, "hash_no_pad_cuda": 0}

_lib = None
_constants_on: set = set()  # device indices whose __constant__ tables are filled


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def launch_counts() -> dict:
    return dict(LAUNCHES)


def hash_no_pad_plain(inputs: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of ``hash_no_pad_cuda`` (chained plain
    permutations), on whatever device ``inputs`` lies."""
    return _hash_n_to_m_no_pad(inputs, 4, permutation=permute_plain)


def find_nvcc() -> str:
    nvcc = shutil.which("nvcc")
    if nvcc is None:
        for cand in (
            os.path.join(os.environ.get("CUDA_HOME", ""), "bin", "nvcc"),
            "/usr/local/cuda/bin/nvcc",
        ):
            if os.path.isfile(cand):
                nvcc = cand
                break
    if nvcc is None:
        raise RuntimeError("nvcc not found: the Poseidon CUDA kernels cannot be built")
    return nvcc


def build(verbose: bool = False) -> float:
    """Compile ``csrc/poseidon.cu`` into ``_build/libposeidon.so`` (always
    recompiles; ``load`` calls it only when the library is missing or older
    than its sources).  Returns nvcc's wall-clock seconds; raises on failure."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{LIBRARY}.{os.getpid()}.tmp"
    cmd = [find_nvcc(), *NVCC_FLAGS]
    if verbose:
        cmd += ["-Xptxas", "-v"]
    cmd += ["-I", CSRC_DIR, "-o", tmp, SOURCE]
    t0 = time.perf_counter()
    res = subprocess.run(cmd, capture_output=True, text=True)
    seconds = time.perf_counter() - t0
    if res.returncode != 0:
        raise RuntimeError(
            f"nvcc failed ({res.returncode}):\n{' '.join(cmd)}\n{res.stdout}\n{res.stderr}"
        )
    if verbose:
        print(res.stdout + res.stderr, flush=True)
    os.replace(tmp, LIBRARY)
    return seconds


def _stale() -> bool:
    if not os.path.isfile(LIBRARY):
        return True
    built = os.path.getmtime(LIBRARY)
    return any(
        os.path.getmtime(os.path.join(CSRC_DIR, f)) > built for f in os.listdir(CSRC_DIR)
    )


def load():
    """The loaded library (built first if needed), with argtypes set."""
    global _lib
    if _lib is not None:
        return _lib
    if _stale():
        build()
    lib = ctypes.CDLL(LIBRARY)
    vp, ll, ci = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    lib.poseidon_set_constants.argtypes = [vp, vp, ctypes.c_ulonglong]
    lib.poseidon_set_constants.restype = ci
    lib.poseidon_permute.argtypes = [vp, vp, ll, vp]
    lib.poseidon_permute.restype = ci
    lib.poseidon_hash_no_pad.argtypes = [vp, ll, ll, ci, vp, ll, vp]
    lib.poseidon_hash_no_pad.restype = ci
    lib.poseidon_error_string.argtypes = [ci]
    lib.poseidon_error_string.restype = ctypes.c_char_p
    _lib = lib
    return lib


def _check(lib, code: int, what: str) -> None:
    if code != 0:
        msg = lib.poseidon_error_string(code).decode()
        raise RuntimeError(f"{what}: CUDA error {code} ({msg})")


def _ready(device: torch.device):
    """Library loaded and its ``__constant__`` tables filled on ``device``."""
    lib = load()
    index = device.index if device.index is not None else torch.cuda.current_device()
    if index not in _constants_on:
        rc = (ctypes.c_ulonglong * len(ALL_ROUND_CONSTANTS))(*ALL_ROUND_CONSTANTS)
        circ = (ctypes.c_ulonglong * SPONGE_WIDTH)(*MDS_MATRIX_CIRC)
        assert not any(MDS_MATRIX_DIAG[1:]), "kernel assumes a single diagonal entry"
        with torch.cuda.device(index):
            code = lib.poseidon_set_constants(
                ctypes.cast(rc, ctypes.c_void_p), ctypes.cast(circ, ctypes.c_void_p),
                MDS_MATRIX_DIAG[0],
            )
        _check(lib, code, "poseidon_set_constants")
        _constants_on.add(index)
    return lib


def permute_cuda(states: torch.Tensor) -> torch.Tensor:
    """Poseidon permutation of [..., 12] int64 bit patterns.

    CUDA tensor: one launch of the hand-written kernel (or an exception).
    CPU tensor: the plain PyTorch version."""
    if states.dtype != torch.int64:
        raise TypeError(f"permute_cuda wants int64 bit patterns, got {states.dtype}")
    if states.dim() < 1 or states.shape[-1] != SPONGE_WIDTH:
        raise ValueError(f"permute_cuda wants [..., {SPONGE_WIDTH}], got {tuple(states.shape)}")
    if not states.is_cuda:
        return permute_plain(states)
    if not states.is_contiguous():
        raise ValueError("permute_cuda wants a contiguous tensor")
    out = torch.empty_like(states)
    rows = states.numel() // SPONGE_WIDTH
    if rows == 0:
        return out
    lib = _ready(states.device)
    with torch.cuda.device(states.device):
        stream = torch.cuda.current_stream().cuda_stream
        code = lib.poseidon_permute(states.data_ptr(), out.data_ptr(), rows, stream)
    LAUNCHES["permute_cuda"] += 1
    _check(lib, code, "poseidon_permute launch")
    return out


def hash_no_pad_cuda(inputs: torch.Tensor) -> torch.Tensor:
    """Fused sponge: [B, width >= 1] int64 bit patterns -> [B, 4] digests.

    Any strides are accepted (the kernel indexes with them).  CUDA tensor:
    one launch (or an exception).  CPU tensor: the plain version."""
    if inputs.dtype != torch.int64:
        raise TypeError(f"hash_no_pad_cuda wants int64 bit patterns, got {inputs.dtype}")
    if inputs.dim() != 2 or inputs.shape[1] < 1:
        raise ValueError(f"hash_no_pad_cuda wants [B, width >= 1], got {tuple(inputs.shape)}")
    if not inputs.is_cuda:
        return hash_no_pad_plain(inputs)
    rows, width = inputs.shape
    out = torch.empty((rows, 4), dtype=torch.int64, device=inputs.device)
    if rows == 0:
        return out
    lib = _ready(inputs.device)
    with torch.cuda.device(inputs.device):
        stream = torch.cuda.current_stream().cuda_stream
        code = lib.poseidon_hash_no_pad(
            inputs.data_ptr(), inputs.stride(0), inputs.stride(1), width,
            out.data_ptr(), rows, stream,
        )
    LAUNCHES["hash_no_pad_cuda"] += 1
    _check(lib, code, "poseidon_hash_no_pad launch")
    return out
