#!/usr/bin/env python3
"""Time variants of the port's Poseidon kernels on one NVIDIA GPU.

    python3 experiments/poseidon_cuda_variants.py [NAME[+NAME...] ...]

Each variant is a copy of ``intmax_zkp_core_tpu_torch/csrc`` with a few text
edits (launch shape, loop unrolling, carries read by compares; names
joined by "+" combine their edits), compiled
with the flags of ``ops/cuda_build.py`` into its own library under
``intmax_zkp_core_tpu_torch/_build/variants/`` (all compilers started
together).  In one process on one card it then prints, per variant, the
SASS counts of chip_smoke.py's ``[sass]`` line and the median ms of
the permutation at [2^18, 12] and of the sponge at [2^18, 135] (the
transposed view of an LDE) and [2^18, 8] (contiguous tree pairs), each
output held against the committed kernels' (the script fails on a
mismatch).  The variants are timed in turns, forwards then backwards, so
that drift of the card shows as a difference between the two passes.
"""

from __future__ import annotations

import ctypes
import os
import re
import shutil
import subprocess
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from chip_smoke import find_cuobjdump, sass_counts, time_ms  # noqa: E402
from intmax_zkp_core_tpu_torch.ops import cuda_build as cb  # noqa: E402
from intmax_zkp_core_tpu_torch.ops import goldilocks as gl  # noqa: E402
from intmax_zkp_core_tpu_torch.ops import poseidon_cuda as pc  # noqa: E402

P = 0xFFFFFFFF00000001

# The loose reductions and add in C, their carries read by compares: the
# form that the carry-chain PTX of goldilocks.cuh is measured against.
_CARRIES_BY_COMPARE = '''__device__ __forceinline__ u64 gl_reduce128_loose(u64 hi, u64 lo) {
    u64 hi_hi = hi >> 32, hi_lo = hi & GL_EPSILON;
    u64 t0 = lo - hi_hi;
    if (lo < hi_hi) t0 -= GL_EPSILON;
    u64 t1 = (hi_lo << 32) - hi_lo;
    u64 t2 = t0 + t1;
    if (t2 < t1) t2 += GL_EPSILON;
    return t2;
}

__device__ __forceinline__ u64 gl_reduce160_loose(u32 top, u64 hi, u64 lo) {
    u64 x = gl_reduce128_loose(hi, lo);
    u64 t = (u64)top << 32;
    u64 d = x - t;
    if (x < t) d -= GL_EPSILON;
    return d;
}

__device__ __forceinline__ u64 gl_fold_reduce_loose(u64 acc_lo, u64 acc_hi, u64 c) {
    u64 low = acc_lo + (acc_hi << 32);
    u64 top = (acc_hi >> 32) + (low < acc_lo ? 1ULL : 0ULL);
    low += c;
    top += low < c ? 1ULL : 0ULL;
    u64 t = (top << 32) - top;
    u64 x = low + t;
    if (x < t) x += GL_EPSILON;
    return x;
}

__device__ __forceinline__ u64 gl_add_loose(u64 a, u64 c) {
    u64 s = a + c;
    if (s < c) s += GL_EPSILON;
    return s;
}

'''

# name -> list of (file, regex, replacement template or function); every
# regex must match.
VARIANTS = {
    "base": [],
    "threads64": [("poseidon.cu", r"#define THREADS 128", "#define THREADS 64")],
    "threads96": [("poseidon.cu", r"#define THREADS 128", "#define THREADS 96")],
    "threads192": [("poseidon.cu", r"#define THREADS 128", "#define THREADS 192")],
    "threads256": [("poseidon.cu", r"#define THREADS 128", "#define THREADS 256")],
    "minblocks1": [("poseidon.cu", r"#define MIN_BLOCKS 3", "#define MIN_BLOCKS 1")],
    "minblocks2": [("poseidon.cu", r"#define MIN_BLOCKS 3", "#define MIN_BLOCKS 2")],
    "minblocks4": [("poseidon.cu", r"#define MIN_BLOCKS 3", "#define MIN_BLOCKS 4")],
    "minblocks5": [("poseidon.cu", r"#define MIN_BLOCKS 3", "#define MIN_BLOCKS 5")],
    "no_minblocks": [("poseidon.cu", r"__launch_bounds__\(THREADS, MIN_BLOCKS\)",
                      "__launch_bounds__(THREADS)")],
    "unroll_full_rounds": [("poseidon.cu", r"#pragma unroll 1\n(\s*)for \(int rnd = 1;",
                            r"#pragma unroll\n\1for (int rnd = 1;")],
    "unroll_partial_2": [("poseidon.cu", r"#pragma unroll 1\n(\s*)for \(int rnd = 0; rnd < N_PARTIAL;",
                          r"#pragma unroll 2\n\1for (int rnd = 0; rnd < N_PARTIAL;")],
    "carries_by_compare": [("goldilocks.cuh",
                            r"__device__ __forceinline__ u64 gl_reduce128_loose\(.*?"
                            r"(?=__device__ __forceinline__ u64 gl_mul_loose)",
                            lambda m: _CARRIES_BY_COMPARE)],
}


def prepare(name: str, edits: list) -> tuple:
    """The variant's sources under _build/variants/<name>/ and the nvcc
    command that builds its library."""
    root = os.path.join(cb.BUILD_DIR, "variants", name)
    shutil.rmtree(root, ignore_errors=True)
    shutil.copytree(cb.CSRC_DIR, os.path.join(root, "csrc"))
    for fname, pattern, repl in edits:
        path = os.path.join(root, "csrc", fname)
        text = open(path).read()
        new, n = re.subn(pattern, repl, text, flags=re.S)
        if n == 0:
            raise RuntimeError(f"variant {name}: {pattern!r} matches nothing in {fname}")
        open(path, "w").write(new)
    lib = os.path.join(root, "libposeidon.so")
    cmd = [cb.find_nvcc(), *cb.NVCC_FLAGS, "-Xcompiler", "-fPIC", "-shared", "-o", lib,
           os.path.join(root, "csrc", "poseidon.cu")]
    return lib, cmd


def load_variant(lib_path: str):
    lib = ctypes.CDLL(lib_path)
    cb.bind(lib, ("poseidon_set_constants", "poseidon_permute", "poseidon_hash_no_pad"))
    if pc.set_constants(lib) != 0:
        raise RuntimeError(f"{lib_path}: poseidon_set_constants failed")
    return lib


def main() -> int:
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    names = sys.argv[1:] or list(VARIANTS)
    device = torch.device("cuda")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip(), flush=True)
    built = {}
    running = []
    for name in names:
        lib, cmd = prepare(name, [e for part in name.split("+") for e in VARIANTS[part]])
        running.append((name, lib, cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                                         stderr=subprocess.PIPE, text=True)))
    for name, lib, cmd, proc in running:
        out, err = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"variant {name} does not build:\n{' '.join(cmd)}\n{out}\n{err}")
        built[name] = load_variant(lib)
    cuobjdump = find_cuobjdump(cb.find_nvcc())

    rng = np.random.default_rng(7)
    B = 1 << 18
    x12 = gl.from_u64(rng.integers(0, P, size=(B, 12), dtype=np.uint64), device)
    x135 = gl.from_u64(rng.integers(0, P, size=(135, B), dtype=np.uint64), device).t()
    x8 = gl.from_u64(rng.integers(0, P, size=(B, 8), dtype=np.uint64), device)
    want = {"permute": pc.permute_cuda(x12), "hash135": pc.hash_no_pad_cuda(x135),
            "hash8": pc.hash_no_pad_cuda(x8)}
    flush = torch.empty(64 << 20, dtype=torch.int64, device=device)
    stream = lambda: torch.cuda.current_stream().cuda_stream  # noqa: E731

    def runs(lib):
        out12 = torch.empty_like(x12)
        out4 = torch.empty((B, 4), dtype=torch.int64, device=device)
        return {
            "permute": (lambda: lib.poseidon_permute(x12.data_ptr(), out12.data_ptr(), B, stream()),
                        out12),
            "hash135": (lambda: lib.poseidon_hash_no_pad(x135.data_ptr(), x135.stride(0),
                                                         x135.stride(1), 135, out4.data_ptr(), B,
                                                         stream()), out4),
            "hash8": (lambda: lib.poseidon_hash_no_pad(x8.data_ptr(), 8, 1, 8, out4.data_ptr(), B,
                                                       stream()), out4),
        }

    times = {name: {k: [] for k in want} for name in names}
    for order in (names, names[::-1]):
        for name in order:
            for key, (fn, out) in runs(built[name]).items():
                times[name][key].append(time_ms(fn, 10 if key != "hash135" else 5, flush))
                if not torch.equal(out, want[key]):
                    raise RuntimeError(f"variant {name} disagrees with the kernels on {key}")
    for name in names:
        lib = os.path.join(cb.BUILD_DIR, "variants", name, "libposeidon.so")
        usage = sass_counts(lib, cuobjdump) if cuobjdump else {}
        print(f"[variant] {name} " + " ".join(
            f"{k}_ms={'/'.join(f'{t:.4f}' for t in v)}" for k, v in times[name].items())
            + " " + " ".join(f"{k}={v}" for k, v in usage.items()), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
