"""The control of a cell's comparison: the program run with one guarantee of
the configuration broken, which the plain reference has to judge not
correct; and the same readings of the program as configured, for the lower
end of each limit.

    python3 port_bench/control.py --workload <cell> --seeds <n> [<n> ...] --seconds <s>
        [--break proof_of_work_bits=8]

runs, in one process, a short window of the cell for each seed, as
configured and then with the break (by default the proof of work ground to
8 bits where the configuration states 16: the step that would save the
grinding), and prints one line of the numbers compared per run.  The
benchmark's own runs never run it."""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

DEFAULT_BREAK = {"proof_of_work_bits": 8}


def readings(bench: dict, cell: dict, seed: int, seconds: float, devices: list,
             overrides: dict | None, **kw) -> dict:
    """One short run's numbers compared, as ``run.py`` prints them."""
    from port_bench.harness.window import run_cell

    result = run_cell(bench, cell, seed, seconds, False, devices, time.perf_counter(),
                      overrides=overrides, **kw)
    checks = result["judgement"]["checks"]
    return {"seed": seed, "broken": overrides or {}, "requests": result["requests"],
            "correct": all(v <= lim for v, lim in checks.values()),
            "checks": {k: v for k, (v, _) in checks.items()}}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, default=10.0)
    ap.add_argument("--break", dest="brk", action="append", default=[],
                    help="key=value of the program's FRI parameters (default proof_of_work_bits=8)")
    ap.add_argument("--sound", type=int, default=1, help="also run each seed as configured")
    args = ap.parse_args(argv)
    import torch

    from port_bench.harness import cells

    bench = cells.load_bench(ROOT)
    cell = cells.workload(bench, args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
        print(f"the cell {cell['name']} needs {cell['chips']} CUDA device(s)", file=sys.stderr)
        return 3
    devices = [torch.device("cuda", i) for i in range(cell["chips"])]
    brk = dict(DEFAULT_BREAK)
    for kv in args.brk:
        k, v = kv.split("=")
        brk[k] = int(v)
    for seed in args.seeds:
        if args.sound:
            print(json.dumps(readings(bench, cell, seed, args.seconds, devices, None)), flush=True)
        print(json.dumps(readings(bench, cell, seed, args.seconds, devices, brk)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
