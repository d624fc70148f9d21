#!/usr/bin/env python3
"""Time the NTT (K2) and Poseidon-gate quotient (K4) kernels of one or more
checkouts of the port at the shapes of a 2^15-row chain proof, on one
NVIDIA GPU.

    python3 experiments/ntt_gate_shapes.py CHECKOUT [CHECKOUT ...]

Each CHECKOUT is the root of a copy of this repository (for example a parent
commit unpacked with ``git archive``).  Each is run in a process of its own,
which builds that checkout's kernels and times its own wrappers
(``ops/ntt_cuda.py::ntt_cuda``, ``ops/gate_quotient_cuda.py::
poseidon_gate_quotient_cuda``) on the same inputs from a fixed seed: the six
NTTs of a proof (the wires' intt [135, 2^15] and ntt [135, 2^18], Z and the
partial products' [24, 2^15] and [24, 2^18], the quotient's intt [2, 2^18] and
ntt [16, 2^18]) and K4 at [1, 135, 2^18], C = 2, each output held against the
checkout's plain version.  The checkouts run in turns, forwards then
backwards, so that drift of the card shows as a difference between the two
passes.  Prints one JSON line per run, median ms by CUDA events with the L2
cache overwritten between runs.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys

SHAPES = (("intt_135x2^15", 135, 15, True), ("ntt_135x2^18", 135, 18, False),
          ("intt_24x2^15", 24, 15, True), ("ntt_24x2^18", 24, 18, False),
          ("intt_2x2^18", 2, 18, True), ("ntt_16x2^18", 16, 18, False))
P = 0xFFFFFFFF00000001


def run_one(root: str) -> dict:
    """Build and time the kernels of the checkout at ``root`` (in this process)."""
    sys.path.insert(0, root)
    import numpy as np
    import torch

    from intmax_zkp_core_tpu_torch.ops import cuda_build as cb
    from intmax_zkp_core_tpu_torch.ops import gate_quotient_cuda as gqc
    from intmax_zkp_core_tpu_torch.ops import ntt_cuda as nc

    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device")
    cb.load()
    device = torch.device("cuda")
    rng = np.random.default_rng(11)

    def field(shape):
        a = rng.integers(0, P, size=shape, dtype=np.uint64)
        return torch.from_numpy(a.view(np.int64)).to(device)

    flush = torch.empty(64 << 20, dtype=torch.int64, device=device)

    def time_ms(fn, reps=20):
        fn()
        torch.cuda.synchronize()
        times = []
        for _ in range(reps):
            flush.zero_()
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            torch.cuda.synchronize()
            times.append(start.elapsed_time(end))
        return float(np.median(times))

    out = {"checkout": root, "device": torch.cuda.get_device_name(0)}
    for name, rows, log_n, inverse in SHAPES:
        x = field((rows, 1 << log_n))
        if not torch.equal(nc.ntt_cuda(x, inverse), nc.ntt_plain(x, inverse)):
            raise RuntimeError(f"{root}: ntt_cuda disagrees with its plain version at {name}")
        out[name] = time_ms(lambda: nc.ntt_cuda(x, inverse))
        del x
    L, C = 1 << 18, 2
    args = [field((1, 135, L)), field((L,)), field((1, C)), field((1, C, L)), field((1, C))]
    got, want = gqc.poseidon_gate_quotient_cuda(*args), gqc.poseidon_gate_quotient_plain(*args)
    if not all(torch.equal(a, b) for a, b in zip(got, want)):
        raise RuntimeError(f"{root}: the gate kernel disagrees with its plain version")
    out["gate_1x135x2^18_C2"] = time_ms(lambda: gqc.poseidon_gate_quotient_cuda(*args))
    return out


def main() -> int:
    if len(sys.argv) >= 3 and sys.argv[1] == "--one":
        print(json.dumps(run_one(os.path.abspath(sys.argv[2]))), flush=True)
        return 0
    roots = [os.path.abspath(r) for r in sys.argv[1:]]
    if not roots:
        print(__doc__.split("\n\n")[1], file=sys.stderr)
        return 2
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip(), flush=True)
    for root in roots + roots[::-1]:
        res = subprocess.run([sys.executable, os.path.abspath(__file__), "--one", root],
                             capture_output=True, text=True)
        if res.returncode != 0:
            print(res.stdout + res.stderr, file=sys.stderr)
            return res.returncode
        print(res.stdout.strip().splitlines()[-1], flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
