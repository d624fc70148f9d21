#!/usr/bin/env python3
"""Time variants of the port's permutation-columns (K3) and
permutation-quotient (K5) kernels on one NVIDIA GPU.

    python3 experiments/perm_variants.py [NAME[+NAME...] ...]

Each variant is a copy of ``intmax_zkp_core_tpu_torch/csrc`` with a few text
edits (block shapes, K5's next chunk's loads issued after this chunk's
products instead of before them, chunk products as a tree instead of a
chain, K5 with one challenge per thread); names joined by "+" combine their
edits.
``perm_columns.cu``, ``perm_quotient.cu`` and ``runtime.cu`` of each are
compiled with the flags of ``ops/cuda_build.py`` into one library under
``intmax_zkp_core_tpu_torch/_build/variants/`` (all compilers started
together).  In one process on one card the script then routes the wrappers
to each library in turn and prints, per variant, the SASS counts of
chip_smoke.py's ``[sass]`` line and the median ms of K3 (the whole
function) at wires [1, 80, 2^15] and of K5 at acc [1, 2, 2^18] with 135 wire
rows behind the view, both at C = 2 as on the main path, each output held
against the committed kernels' (the script fails on a mismatch).  The
variants are timed in turns, forwards then backwards, so that drift of the
card shows as a difference between the two passes.  For the committed form
it also gives the device ms of each of K3's three launches
(``torch.profiler``).
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
    find_cuobjdump, perm_columns_inputs, perm_quotient_inputs, sass_counts, time_ms,
)
from intmax_zkp_core_tpu_torch.ops import cuda_build as cb  # noqa: E402
from intmax_zkp_core_tpu_torch.ops import perm_columns_cuda as pcol  # noqa: E402
from intmax_zkp_core_tpu_torch.ops import perm_quotient_cuda as pq  # noqa: E402

SOURCES = ("perm_columns.cu", "perm_quotient.cu", "runtime.cu")
SYMBOLS = ("perm_columns_row_block", "perm_columns_rows", "perm_columns_carries",
           "perm_columns_finish", "perm_quotient")

# name -> list of (file, regex, replacement); every regex must match.
VARIANTS = {
    "base": [],
    # K5: the next chunk's loads issued after this chunk's products (no prefetch)
    "k5_no_prefetch": [
        ("perm_quotient.cu", r"if \(j \+ 1 < nch\)\n(\s*)load_chunk<CG>\(wn, sn, nxn,",
         r"if (false)\n\1load_chunk<CG>(wn, sn, nxn,"),
        ("perm_quotient.cu", r"for \(int i = 0; i < CHUNK; \+\+i\) \{\n\s*wv\[i\] = wn\[i\];\n"
                             r"\s*sv\[i\] = sn\[i\];\n\s*\}\n#pragma unroll\n"
                             r"\s*for \(int c = 0; c < CG; \+\+c\) nxt\[c\] = nxn\[c\];",
         "for (int i = 0; i < 1; ++i) {}\n        if (j + 1 < nch)\n"
         "            load_chunk<CG>(wv, sv, nxt, w, wires_row_stride, sigma + t, zs, pps, kc0, t,\n"
         "                           t_next, L, nch, R, j + 1);"),
    ],
    # both: each whole chunk's product as a tree of depth 3 instead of a chain
    "tree_products": [("perm_chunk.cuh", r"(chunk_product\(int m, Fac fac\) \{\n)",
                        r"\1    if (m == CHUNK) {\n"
                        r"        const u64 p01 = gl_mul_loose(fac(0), fac(1)), p23 = gl_mul_loose(fac(2), fac(3));\n"
                        r"        const u64 p45 = gl_mul_loose(fac(4), fac(5));\n"
                        r"        return gl_mul_loose(gl_mul_loose(p01, p23), gl_mul_loose(p45, fac(6)));\n"
                        r"    }\n")],
    # K5: one challenge per thread, the challenges along the grid (its
    # launcher's path for C > 4)
    "k5_thread_per_challenge": [("perm_quotient.cu", r"switch \(C\) \{", "switch (0) {")],
    "k3_rows64": [("perm_columns.cu", r"#define ROWS 128", "#define ROWS 64")],
    "k3_rows256": [("perm_columns.cu", r"#define ROWS 128", "#define ROWS 256")],
    "k5_threads128": [("perm_quotient.cu", r"#define THREADS 256", "#define THREADS 128")],
    "k5_threads512": [("perm_quotient.cu", r"#define THREADS 256", "#define THREADS 512")],
}
REPORTED = ("perm_columns_rows_kernel", "perm_columns_finish_kernel", "perm_quotient_kernel<2>",
            "perm_quotient_kernel<1>")


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
    lib = os.path.join(root, "libperm.so")
    cmd = [cb.find_nvcc(), *cb.NVCC_FLAGS, "-Xcompiler", "-fPIC", "-shared", "-o", lib,
           *(os.path.join(root, "csrc", f) for f in SOURCES)]
    return lib, cmd


def load_variant(lib_path: str):
    lib = ctypes.CDLL(lib_path)
    cb.bind(lib, SYMBOLS)
    lib.kernels_error_string.argtypes = [ctypes.c_int]
    lib.kernels_error_string.restype = ctypes.c_char_p
    return lib


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
    k3_args = perm_columns_inputs(rng, device, 1, 2, 80, 1 << 15)
    k5_args = perm_quotient_inputs(rng, device, 1, 2, 80, 1 << 18, extra_rows=55)
    runs = {"k3_C2": lambda: pcol.perm_columns_cuda(*k3_args),
            "k5_C2": lambda: pq.perm_quotient_cuda(*k5_args, 8)}
    want = {key: fn() for key, fn in runs.items()}
    flush = torch.empty(64 << 20, dtype=torch.int64, device=device)

    times = {name: {k: [] for k in runs} for name in names}
    for order in (names, names[::-1]):
        for name in order:
            cb._lib = built[name]  # the wrappers launch from this library
            try:
                for key, fn in runs.items():
                    times[name][key].append(time_ms(fn, 20, flush))
                    if not all(torch.equal(a, b) for a, b in zip(fn(), want[key])):
                        raise RuntimeError(f"variant {name} disagrees with the kernels on {key}")
            finally:
                cb._lib = committed
    for name in names:
        lib = os.path.join(cb.BUILD_DIR, "variants", name, "libperm.so")
        usage = sass_counts(lib, cuobjdump) if cuobjdump else {}
        usage = {k: v for k, v in usage.items() if k in REPORTED}
        print(f"[variant] {name} " + " ".join(
            f"{k}_ms={'/'.join(f'{t:.4f}' for t in v)}" for k, v in times[name].items())
            + " " + " ".join(f"{k}={v}" for k, v in usage.items()), flush=True)

    # the three launches of the committed K3 apart, by the profiler's device time
    from torch.profiler import ProfilerActivity, profile

    reps = 20
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            runs["k3_C2"]()
        torch.cuda.synchronize()
    passes = {}
    for ev in prof.key_averages():
        for sym in ("perm_columns_rows_kernel", "perm_columns_carries_kernel",
                    "perm_columns_finish_kernel"):
            if sym in ev.key:
                passes[sym] = round(ev.device_time_total / reps / 1e3, 4)
    print("[passes] k3_C2 " + " ".join(f"{k}_ms={v}" for k, v in passes.items()), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
