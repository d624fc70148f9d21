"""Build, load and launch bookkeeping shared by every CUDA kernel of the port.

The sources are ``csrc/*.cu`` over ``csrc/goldilocks.cuh``.  ``nvcc`` compiles
each source for ``sm_90a`` into an object under ``_build/`` (one compiler
process per source, all started together) and links them into one shared
library with a plain C interface, which ``ctypes`` loads.  That happens at
first use, and again whenever a source is newer than the library.  A compiler
or loader failure is an exception: no caller carries on without its kernel.

The wrappers live beside their plain PyTorch versions in
``ops/{poseidon,zinv_mul,fri_init,perm_quotient,perm_columns,gate_quotient,ntt}_cuda.py``.  Each
adds one to its entry of ``LAUNCHES`` where it launches its kernel, and
nowhere else.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import threading
import time

import torch

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(_PKG_DIR, "csrc")
BUILD_DIR = os.path.join(_PKG_DIR, "_build")
LIBRARY = os.path.join(BUILD_DIR, "libkernels.so")

NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3"]

# One key per kernel wrapper; a wrapper of several launches counts each.
LAUNCHES = {
    "permute_cuda": 0,
    "hash_no_pad_cuda": 0,
    "perm_columns_cuda": 0,
    "perm_quotient_cuda": 0,
    "zinv_mul_cuda": 0,
    "fri_initial_cuda": 0,
    "poseidon_gate_quotient_cuda": 0,
    "ntt_cuda": 0,
}

_VP, _LL, _CI, _ULL = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int, ctypes.c_ulonglong
# C interface of the library: every pointer and the stream as c_void_p (left
# undeclared, ctypes would cut them to 32 bits); every launcher returns
# cudaGetLastError().
_ARGTYPES = {
    "poseidon_set_constants": [_VP, _ULL, _VP, _VP, _VP],
    "poseidon_permute": [_VP, _VP, _LL, _VP],
    "poseidon_hash_no_pad": [_VP, _LL, _LL, _CI, _VP, _LL, _VP],
    "zinv_mul_threads": [],
    "zinv_mul_points": [],
    "zinv_mul": [_VP, _VP, _VP, _LL, _LL, _VP],
    "fri_initial_threads": [],
    "fri_initial_points": [],
    "fri_initial": [_VP, _VP, _VP, _VP, _VP, _VP, _VP, _VP, _LL, _LL, _VP],
    "perm_quotient": [_VP, _LL, _LL, _VP, _VP, _VP, _VP, _VP, _VP, _VP, _VP, _VP, _VP, _VP,
                      _CI, _CI, _CI, _CI, _LL, _LL, _VP],
    "perm_columns_row_block": [],
    "perm_columns_rows": [_VP, _LL, _LL, _VP, _VP, _VP, _VP, _VP, _VP, _VP, _VP,
                          _CI, _CI, _CI, _CI, _LL, _LL, _VP],
    "perm_columns_carries": [_VP, _VP, _CI, _CI, _LL, _VP],
    "perm_columns_finish": [_VP, _VP, _VP, _CI, _CI, _CI, _LL, _LL, _VP],
    "gate_quotient_set_constants": [_VP, _VP, _ULL, _VP, _VP, _VP],
    "gate_quotient": [_VP, _LL, _LL, _VP, _VP, _VP, _VP, _VP, _VP, _CI, _CI, _LL, _VP],
    "ntt_local": [_VP, _VP, _CI, _CI, _CI, _CI, _LL, _CI, _CI, _CI, _VP, _VP, _CI, _ULL, _CI,
                  _ULL, _ULL, _ULL, _VP],
    "ntt_transpose": [_VP, _VP, _CI, _CI, _CI, _VP],
}

# The grid's second and third axes take at most this many blocks: a kernel
# that puts rows or proofs there is launched once per chunk of them.
MAX_GRID_YZ = 65535


def grid_chunks(k: int) -> list:
    """[start, stop) ranges covering 0 .. k - 1, none longer than
    ``MAX_GRID_YZ``."""
    return [(a, min(a + MAX_GRID_YZ, k)) for a in range(0, k, MAX_GRID_YZ)]

_lib = None
# the proof axis over several cards launches from one host thread per card:
# the library is loaded (built) once, and no count is lost
_lock = threading.Lock()


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def launch_counts() -> dict:
    return dict(LAUNCHES)


def sources() -> list:
    """The kernel sources, ``csrc/*.cu``, by path."""
    return sorted(
        os.path.join(CSRC_DIR, f) for f in os.listdir(CSRC_DIR) if f.endswith(".cu")
    )


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
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return nvcc


def _wait(cmd: list, proc: subprocess.Popen, verbose: bool) -> None:
    out, err = proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{' '.join(cmd)}\n{out}\n{err}")
    if verbose:
        print(out + err, flush=True)


def build(verbose: bool = False) -> float:
    """Compile every ``csrc/*.cu`` and link ``_build/libkernels.so`` (always
    recompiles; ``load`` calls it only when the library is missing or older
    than its sources).  ``verbose`` prints what ``ptxas -v`` says of each
    kernel.  Returns the wall-clock seconds; raises on failure."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    nvcc = find_nvcc()
    t0 = time.perf_counter()
    objects, running = [], []
    for src in sources():
        obj = os.path.join(BUILD_DIR, f"{os.path.basename(src)[:-3]}.{os.getpid()}.o")
        cmd = [nvcc, *NVCC_FLAGS, "-Xcompiler", "-fPIC", "-I", CSRC_DIR]
        if verbose:
            cmd += ["-Xptxas", "-v"]
        cmd += ["-c", "-o", obj, src]
        objects.append(obj)
        running.append((cmd, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)))
    try:
        failure = None
        for cmd, proc in running:  # every compiler is waited for, also after a failure
            try:
                _wait(cmd, proc, verbose)
            except RuntimeError as exc:
                failure = failure or exc
        if failure is not None:
            raise failure
        tmp = f"{LIBRARY}.{os.getpid()}.tmp"
        cmd = [nvcc, *NVCC_FLAGS, "-shared", "-o", tmp, *objects]
        _wait(cmd, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True), verbose)
        os.replace(tmp, LIBRARY)
    finally:
        for obj in objects:
            if os.path.exists(obj):
                os.remove(obj)
    return time.perf_counter() - t0


def _stale() -> bool:
    if not os.path.isfile(LIBRARY):
        return True
    built = os.path.getmtime(LIBRARY)
    return any(
        os.path.getmtime(os.path.join(CSRC_DIR, f)) > built for f in os.listdir(CSRC_DIR)
    )


def bind(lib, names=_ARGTYPES) -> None:
    """Declare the C signatures of ``names`` (entries of the library's
    interface) on a loaded ``lib``."""
    for name in names:
        fn = getattr(lib, name)
        fn.argtypes = _ARGTYPES[name]
        fn.restype = _CI


def load():
    """The loaded library (built first if needed), with argtypes set."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        if _stale():
            build()
        lib = ctypes.CDLL(LIBRARY)
        bind(lib)
        lib.kernels_error_string.argtypes = [_CI]
        lib.kernels_error_string.restype = ctypes.c_char_p
        _lib = lib
        return lib


def check(code: int, what: str) -> None:
    """Raise if a launcher returned another code than ``cudaSuccess``."""
    if code != 0:
        msg = load().kernels_error_string(code).decode()
        raise RuntimeError(f"{what}: CUDA error {code} ({msg})")


def launch(name: str, symbol: str, device: torch.device, *args) -> None:
    """Launch ``symbol`` of the library on ``device``'s current stream (the
    stream is appended to ``args``), count it under ``name`` and raise if the
    launch was refused."""
    fn = getattr(load(), symbol)
    with torch.cuda.device(device):
        code = fn(*args, torch.cuda.current_stream().cuda_stream)
    with _lock:
        LAUNCHES[name] += 1
    check(code, f"{symbol} launch")


def require_field(name: str, **tensors) -> None:
    """Every tensor handed to a kernel wrapper holds int64 bit patterns."""
    for arg, t in tensors.items():
        if t.dtype != torch.int64:
            raise TypeError(f"{name} wants int64 bit patterns, got {arg} of {t.dtype}")


def require_same_device(name: str, first: torch.Tensor, **tensors) -> None:
    for arg, t in tensors.items():
        if t.device != first.device:
            raise ValueError(f"{name}: {arg} lies on {t.device}, not on {first.device}")


def require_contiguous(name: str, **tensors) -> None:
    for arg, t in tensors.items():
        if not t.is_contiguous():
            raise ValueError(f"{name} wants a contiguous {arg}")
