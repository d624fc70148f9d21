#!/usr/bin/env python3
"""Time variants of the port's NTT (K2) and Poseidon-gate quotient (K4)
kernels on one NVIDIA GPU.

    python3 experiments/ntt_gate_variants.py [NAME[+NAME...] ...]

Each variant is a copy of ``intmax_zkp_core_tpu_torch/csrc`` with a few text
edits (block shape, unrolling, the shared-memory swizzle; the DIAG_ ones
drop arithmetic to show what the memory traffic alone costs), and for some a
launch-plan constant of ``ops/ntt_cuda.py`` set while it runs; names joined
by "+" combine their edits.  ``ntt.cu``, ``gate_quotient.cu`` and
``runtime.cu`` of each are compiled with the flags of ``ops/cuda_build.py``
into one library under ``intmax_zkp_core_tpu_torch/_build/variants/`` (all
compilers started together).  In one process on one card the script then
routes the wrappers to each library in turn and prints, per variant, the
SASS counts of chip_smoke.py's ``[sass]`` line and the median ms of the NTT
at the shapes of a 2^15-row chain proof and of K4 at [1, 135, 2^18], C = 2,
each output held against the committed kernels' (the script fails on a
mismatch).  The variants are timed in turns, forwards then backwards, so
that drift of the card shows as a difference between the two passes.  For
the committed form it also times the two launches of the 2^18 four-step
apart.
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

from chip_smoke import find_cuobjdump, gate_quotient_inputs, rand_field, sass_counts, time_ms  # noqa: E402
from intmax_zkp_core_tpu_torch.ops import cuda_build as cb  # noqa: E402
from intmax_zkp_core_tpu_torch.ops import gate_quotient_cuda as gqc  # noqa: E402
from intmax_zkp_core_tpu_torch.ops import ntt_cuda as nc  # noqa: E402

SOURCES = ("ntt.cu", "gate_quotient.cu", "runtime.cu")
# the NTT shapes of one 2^15-row chain proof: (rows, log n, inverse)
NTT_SHAPES = ((135, 15, True), (135, 18, False), (24, 15, True), (24, 18, False),
              (2, 18, True), (16, 18, False))

# name -> (list of (file, regex, replacement), {ops.ntt_cuda constant: value});
# every regex must match.
VARIANTS = {
    "base": ([], {}),
    "ntt_threads128": ([("ntt.cu", r"#define THREADS 256", "#define THREADS 128"),
                        ("ntt.cu", r"#define MIN_BLOCKS 4", "#define MIN_BLOCKS 8")], {}),
    "ntt_threads512": ([("ntt.cu", r"#define THREADS 256", "#define THREADS 512"),
                        ("ntt.cu", r"#define MIN_BLOCKS 4", "#define MIN_BLOCKS 2")], {}),
    "ntt_minblocks1": ([("ntt.cu", r"#define MIN_BLOCKS 4", "#define MIN_BLOCKS 1")], {}),
    # 16 strided sequences of 2^9 per block (128-byte segments), 64 KB, three blocks to an SM
    "ntt_block64k_group16": ([("ntt.cu", r"#define BLOCK_LOG_ELEMS 12", "#define BLOCK_LOG_ELEMS 13"),
                              ("ntt.cu", r"#define MIN_BLOCKS 4", "#define MIN_BLOCKS 3")],
                             {"BLOCK_LOG_ELEMS": 13, "COALESCED_LOG_GROUP": 4}),
    "ntt_no_swizzle": ([("ntt.cu", r"return a \^ \(\(\(a >> 4\) \^ \(a >> 8\) \^ \(a >> 12\)\) & 15\);",
                         "return a;")], {}),
    "ntt_units_unroll2": ([("ntt.cu", r"(    // pass 1: device memory -> registers -> the first R1 stages\.)",
                            r"#pragma unroll 2\n\1"),
                           ("ntt.cu", r"(        // last pass: shared memory -> twiddle, three stages -> device memory\n)",
                            r"\1#pragma unroll 2\n")], {}),
    # diagnostics (their outputs are wrong and not compared): the same
    # memory traffic with no arithmetic, and the four-step without its twiddle
    "DIAG_ntt_copy_only": ([("ntt.cu", r"(void dit\(u64 \(&y\)\[R\], u64 w4, u64 w8, u64 w8_3\) \{\n).*?(\n\}\n)",
                             r"\1    return;\2"),
                            ("ntt.cu", r"(int shift\) \{\n)", r"\1    return;\n"),
                            ("ntt.cu", r"if \(post_tw != nullptr\) \{", "if (false) {")], {}),
    "DIAG_ntt_no_post": ([("ntt.cu", r"if \(post_tw != nullptr\) \{", "if (false) {")], {}),
    "gate_x_unroll1": ([("gate_quotient.cu", r"#pragma unroll 2\n(\s*)for \(int i = 0; i < n_x;",
                         r"#pragma unroll 1\n\1for (int i = 0; i < n_x;")], {}),
    "gate_x_unroll4": ([("gate_quotient.cu", r"#pragma unroll 2\n(\s*)for \(int i = 0; i < n_x;",
                         r"#pragma unroll 4\n\1for (int i = 0; i < n_x;")], {}),
    "gate_rows_unrolled": ([("gate_quotient.cu", r"#pragma unroll 1\n(\s*)for \(int r = 0; r < N_PARTIAL;",
                             r"#pragma unroll\n\1for (int r = 0; r < N_PARTIAL;"),
                            ("gate_quotient.cu", r"#pragma unroll 1\n(\s*)for \(int lane = 0;",
                             r"#pragma unroll\n\1for (int lane = 0;"),
                            ("gate_quotient.cu", r"#pragma unroll 2\n(\s*)for \(int i = 0; i < n_x;",
                             r"#pragma unroll\n\1for (int i = 0; i < n_x;")], {}),
    "gate_threads128": ([("gate_quotient.cu", r"#define THREADS 256", "#define THREADS 128")], {}),
    "gate_threads512": ([("gate_quotient.cu", r"#define THREADS 256", "#define THREADS 512")], {}),
    "gate_minblocks4": ([("gate_quotient.cu", r"__launch_bounds__\(THREADS\)",
                          "__launch_bounds__(THREADS, 4)")], {}),
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
    lib = os.path.join(root, "libntt_gate.so")
    cmd = [cb.find_nvcc(), *cb.NVCC_FLAGS, "-Xcompiler", "-fPIC", "-shared", "-o", lib,
           *(os.path.join(root, "csrc", f) for f in SOURCES)]
    return lib, cmd


def load_variant(lib_path: str):
    lib = ctypes.CDLL(lib_path)
    cb.bind(lib, ("ntt_local", "gate_quotient_set_constants", "gate_quotient"))
    lib.kernels_error_string.argtypes = [ctypes.c_int]
    lib.kernels_error_string.restype = ctypes.c_char_p
    return lib


def use(lib, constants: dict) -> dict:
    """Route the wrappers to ``lib`` (its constants uploaded) with the given
    ``ops.ntt_cuda`` constants set; returns the constants to put back."""
    cb._lib = lib
    cb.check(gqc.set_constants(lib), "gate_quotient_set_constants")
    old = {k: getattr(nc, k) for k in constants}
    for k, v in constants.items():
        setattr(nc, k, v)
    return old


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
        lib, cmd = prepare(name, [e for part in name.split("+") for e in VARIANTS[part][0]])
        running.append((name, lib, cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                                         stderr=subprocess.PIPE, text=True)))
    for name, lib, cmd, proc in running:
        out, err = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"variant {name} does not build:\n{' '.join(cmd)}\n{out}\n{err}")
        built[name] = load_variant(lib)
    cuobjdump = find_cuobjdump(cb.find_nvcc())

    rng = np.random.default_rng(9)
    inputs = {f"ntt{'_i' if inv else ''}_{rows}x2^{log_n}": (rand_field(rng, (rows, 1 << log_n), device), inv)
              for rows, log_n, inv in NTT_SHAPES}
    gate_args = gate_quotient_inputs(rng, device, 1, 2, 1 << 18)
    runs = {key: (lambda x=x, inv=inv: nc.ntt_cuda(x, inv)) for key, (x, inv) in inputs.items()}
    runs["gate_C2"] = lambda: gqc.poseidon_gate_quotient_cuda(*gate_args)
    want = {key: fn() for key, fn in runs.items()}
    flush = torch.empty(64 << 20, dtype=torch.int64, device=device)

    times = {name: {k: [] for k in runs} for name in names}
    for order in (names, names[::-1]):
        for name in order:
            old = use(built[name], {k: v for part in name.split("+")
                                    for k, v in VARIANTS[part][1].items()})
            try:
                for key, fn in runs.items():
                    times[name][key].append(time_ms(fn, 10, flush))
                    got = fn()
                    same = (all(torch.equal(a, b) for a, b in zip(got, want[key]))
                            if isinstance(got, tuple) else torch.equal(got, want[key]))
                    if not same and not name.startswith("DIAG_"):
                        raise RuntimeError(f"variant {name} disagrees with the kernels on {key}")
            finally:
                use(committed, old)
    for name in names:
        lib = os.path.join(cb.BUILD_DIR, "variants", name, "libntt_gate.so")
        usage = sass_counts(lib, cuobjdump) if cuobjdump else {}
        usage = {k: v for k, v in usage.items()
                 if k in ("ntt_local_kernel<9,0,0>", "ntt_local_kernel<9,1,0>",
                          "ntt_local_kernel<7,0,0>", "ntt_local_kernel<8,1,0>",
                          "gate_quotient_kernel<2>")}
        print(f"[variant] {name} " + " ".join(
            f"{k}_ms={'/'.join(f'{t:.4f}' for t in v)}" for k, v in times[name].items())
            + " " + " ".join(f"{k}={v}" for k, v in usage.items()), flush=True)

    # the two launches of the committed ntt [135, 2^18] apart
    x, inv = inputs["ntt_135x2^18"]
    B, n = x.shape
    log_n1 = (n.bit_length() - 1) // 2
    log_n2 = n.bit_length() - 1 - log_n1
    n1, n2 = 1 << log_n1, 1 << log_n2
    mid, out = torch.empty_like(x), torch.empty_like(x)
    table = nc.fourstep_twiddles(log_n1, log_n2, inv, device)
    first = time_ms(lambda: nc._local(x, mid, log_n1, n2, B, n, (1, n2), (1, n2), inv,
                                      post=(table, n2)), 10, flush)
    second = time_ms(lambda: nc._local(mid, out, log_n2, n1, B, n, (n2, 1), (1, n1), inv), 10, flush)
    print(f"[launches] ntt_135x2^18 columns_ms={first:.4f} rows_ms={second:.4f}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
