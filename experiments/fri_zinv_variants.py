#!/usr/bin/env python3
"""Time variants of the port's divide by Z_H (K6, ``zinv_mul_cuda``) and
initial FRI quotient (K7, ``fri_initial_cuda``) on one NVIDIA GPU.

    python3 experiments/fri_zinv_variants.py [NAME[+NAME...] ...]

Each variant is a copy of ``intmax_zkp_core_tpu_torch/csrc`` with a few text
edits: the points a thread takes (each thread's product goes into the
block's one chain), the threads a block, the per-thread batch (every thread
running the chain on its own product; with one point a thread that is one
chain per point, on the loose arithmetic), the per-warp batch (every lane
running the chain on its warp's total), K6 without its L2 prefetch and K7
with its loads after the chain.  Names joined by "+" combine their edits.
``zinv_mul.cu``, ``fri_init.cu`` and ``runtime.cu`` of each are compiled
with the flags of ``ops/cuda_build.py`` into one library under
``intmax_zkp_core_tpu_torch/_build/variants/`` (all compilers started
together).  In one process on one card the script then routes the wrappers to
each library in turn and prints, per variant, the SASS counts of
chip_smoke.py's ``[sass]`` line and the median ms of K6 at acc [2, 2^18] and
of K7 at comb [1, 2^18, 2], the main path's shapes.  Each variant's output is
held against the committed kernels' at those shapes and against the plain
versions on edge lanes with zeros planted by its own layout (the
script fails on a mismatch).  The variants are timed in turns, forwards then
backwards, so that drift of the card shows as a difference between the two
passes.  Names with a ``diag_`` part are diagnostics whose values are wrong:
they are timed and not checked.
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

from chip_smoke import (  # noqa: E402
    P, batch_points, edge_field, find_cuobjdump, fri_initial_inputs, rand_field, sass_counts,
    time_ms,
)
from intmax_zkp_core_tpu_torch.ops import cuda_build as cb  # noqa: E402
from intmax_zkp_core_tpu_torch.ops import fri_init_cuda as fi  # noqa: E402
from intmax_zkp_core_tpu_torch.ops import goldilocks as gl  # noqa: E402
from intmax_zkp_core_tpu_torch.ops import zinv_mul_cuda as zm  # noqa: E402

SOURCES = ("zinv_mul.cu", "fri_init.cu", "runtime.cu")
SYMBOLS = ("zinv_mul_threads", "zinv_mul_points", "zinv_mul", "fri_initial_threads",
           "fri_initial_points", "fri_initial")

WARP_INV = r'''// 1 / x for the thread's x, the warp's lanes sharing one chain
__device__ __forceinline__ u64 warp_inv(u64 x) {
    const int lane = threadIdx.x % 32;
    u64 pre = x, suf = x;  // x_0 .. x_lane and x_lane .. x_31
#pragma unroll
    for (int d = 1; d < 32; d *= 2) {
        const u64 y = __shfl_up_sync(0xffffffffu, pre, d), z = __shfl_down_sync(0xffffffffu, suf, d);
        if (lane >= d) pre = gl_mul_loose(pre, y);
        if (lane + d < 32) suf = gl_mul_loose(suf, z);
    }
    const u64 inv = inv_loose(__shfl_sync(0xffffffffu, pre, 31));
    u64 before = __shfl_up_sync(0xffffffffu, pre, 1), after = __shfl_down_sync(0xffffffffu, suf, 1);
    if (lane == 0) before = 1;
    if (lane == 31) after = 1;
    return gl_mul_loose(inv, gl_mul_loose(before, after));
}

\1'''


def _points(n):
    return [(f, r"#define POINTS 4", f"#define POINTS {n}") for f in ("zinv_mul.cu", "fri_init.cu")]


def _threads(n):
    return [(f, r"#define THREADS 128", f"#define THREADS {n}") for f in ("zinv_mul.cu", "fri_init.cu")]


# name -> list of (file, regex, replacement); every regex must match.
VARIANTS = {
    "base": [],
    "points1": _points(1),
    "points2": _points(2),
    "points8": _points(8),
    "points16": _points(16),
    "threads64": _threads(64),
    "threads256": _threads(256),
    # K6: acc read after the chain only (no L2 prefetch before it)
    "no_prefetch": [("zinv_mul.cu", r"    // the thread's acc values are fetched.*?\n    }\n", "")],
    # K7: comb1 and comb2 loaded after the chain, where they are used
    "late_loads": [
        ("fri_init.cu", r"        if \(t < L\) \{\n            a\[i\] = .*?\n        }\n", ""),
        ("fri_init.cu", r"(        if \(t >= L\) continue;\n)",
         r"\1        a[i] = comb1[k * L + t];\n        b[i] = comb2[k * L + t];\n"),
    ],
    # diagnostic, values wrong: the block's scans and chain left out (each
    # thread's product taken as its own inverse), to show what the rest of a
    # kernel costs
    "diag_no_chain": [("goldilocks.cuh", r"u64 inv = block_inv_loose<THREADS>\(pre\[N - 1\]\);",
                       "u64 inv = pre[N - 1];")],
    # diagnostic, values wrong: the inputs read and the output written with
    # no arithmetic between them
    "diag_copy": [
        ("zinv_mul.cu", r"    batch_inv_loose<THREADS>\(inv\);\n", ""),
        ("zinv_mul.cu", r"gl_canon\(gl_mul_loose\(acc\[r \* L \+ t\], inv\[i\]\)\)",
         "acc[r * L + t] ^ inv[i]"),
        ("fri_init.cu", r"    batch_inv_loose<THREADS>\(inv\);\n", ""),
        ("fri_init.cu", r"out\[k \* L \+ t\] = g;",
         "out[k * L + t] = make_ulonglong2(a[i].x ^ b[i].x ^ x[i], a[i].y ^ b[i].y);"),
    ],
    "warp_batch": [
        ("goldilocks.cuh", r"(// 1 / x for every thread's loose x)", WARP_INV),
        ("goldilocks.cuh", r"u64 inv = block_inv_loose<THREADS>\(pre\[N - 1\]\);",
         "u64 inv = warp_inv(pre[N - 1]);"),
    ],
    # the per-thread batch: each thread runs the chain on its own product
    "thread_batch": [("goldilocks.cuh", r"u64 inv = block_inv_loose<THREADS>\(pre\[N - 1\]\);",
                      "u64 inv = inv_loose(pre[N - 1]);")],
}
REPORTED = ("zinv_mul_kernel", "fri_initial_kernel")


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
    lib = os.path.join(root, "libfrizinv.so")
    cmd = [cb.find_nvcc(), *cb.NVCC_FLAGS, "-Xcompiler", "-fPIC", "-shared", "-o", lib,
           *(os.path.join(root, "csrc", f) for f in SOURCES)]
    return lib, cmd


def load_variant(lib_path: str):
    lib = ctypes.CDLL(lib_path)
    cb.bind(lib, SYMBOLS)
    lib.kernels_error_string.argtypes = [ctypes.c_int]
    lib.kernels_error_string.restype = ctypes.c_char_p
    return lib


def zero_inputs(rng, device, L):
    """Edge lanes with zeros planted by the loaded library's layout as
    chip_smoke.py plants them: (K6 args, K7 args)."""
    batch = batch_points(zm.batch_layout(), L)
    acc, z_h = edge_field(rng, (2, L), device), edge_field(rng, (L,), device)
    z_h[[batch[0], batch[len(batch) // 2], batch[-1]]] = 0
    z_h[[t + 2 for t in batch]] = 0
    span = zm.batch_layout()[0] * zm.batch_layout()[1]
    z_h[2 * span : 3 * span] = 0
    batch = batch_points(fi.batch_layout(), L)
    xs = gl.from_u64(rng.integers(0, P, size=L, dtype=np.uint64), device)
    args = [edge_field(rng, (3, L, 2), device), edge_field(rng, (3, L, 2), device), xs]
    args += [edge_field(rng, (3, 2), device) for _ in range(4)]
    for k, i in enumerate((0, len(batch) // 2, len(batch) - 1)):
        args[3][k] = torch.stack([xs[batch[i]], xs.new_zeros(())])
        args[4][k] = torch.stack([xs[batch[i] + 1], xs.new_zeros(())])
    return (acc, z_h), args


def main() -> int:
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    names = sys.argv[1:] or list(VARIANTS)
    device = torch.device("cuda")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip(), flush=True)
    committed = cb.load()
    built, running = {}, []
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

    rng = np.random.default_rng(9)
    L, blowup = 1 << 18, 8
    acc = rand_field(rng, (2, L), device)
    z_h = gl.sub(rand_field(rng, (blowup,), device), 1).repeat(L // blowup)  # Z_H on the coset
    k7_args = fri_initial_inputs(rng, device, 1, L)
    runs = {"k6": lambda: zm.zinv_mul_cuda(acc, z_h), "k7": lambda: fi.fri_initial_cuda(*k7_args)}
    want = {key: fn() for key, fn in runs.items()}
    flush = torch.empty(64 << 20, dtype=torch.int64, device=device)

    times = {name: {k: [] for k in runs} for name in names}
    for order in (names, names[::-1]):
        for name in order:
            cb._lib = built[name]  # the wrappers launch from this library
            try:
                if order is names and "diag_" not in name:
                    k6_zero, k7_zero = zero_inputs(rng, device, (1 << 13) + 8)
                    if not (torch.equal(zm.zinv_mul_cuda(*k6_zero), zm.zinv_mul_plain(*k6_zero))
                            and torch.equal(fi.fri_initial_cuda(*k7_zero),
                                            fi.fri_initial_plain(*k7_zero))):
                        raise RuntimeError(f"variant {name} disagrees with the plain versions")
                for key, fn in runs.items():
                    times[name][key].append(time_ms(fn, 20, flush))
                    if "diag_" not in name and not torch.equal(fn(), want[key]):
                        raise RuntimeError(f"variant {name} disagrees with the kernels on {key}")
            finally:
                cb._lib = committed
    for name in names:
        lib = os.path.join(cb.BUILD_DIR, "variants", name, "libfrizinv.so")
        usage = sass_counts(lib, cuobjdump) if cuobjdump else {}
        usage = {k: v for k, v in usage.items() if k in REPORTED}
        print(f"[variant] {name} " + " ".join(
            f"{k}_ms={'/'.join(f'{t:.4f}' for t in v)}" for k, v in times[name].items())
            + " " + " ".join(f"{k}={v}" for k, v in usage.items()), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
