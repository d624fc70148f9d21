"""Run one cell of the benchmark once.

    python3 port_bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout.  The cell, its configuration, its traffic mix
and its metrics are found by name (``BENCHMARK.json``, ``configs/``,
``traffic/``, ``metrics/``).  Set-up (imports, the kernel library, the
warm-up of each card, the circuits from the circuit cache, one warm request)
is ``setup_s``; then a closed loop serves requests for ``--seconds``
seconds, finishing the one in flight.  ``--trace 0`` reports the cell's
end-to-end metrics, ``--trace 1`` its per-layer metrics.  The last line of
standard output is the result as one JSON object; the last lines of
standard error are the numbers compared with the plain reference, each
beside its limit.  Exits 3, printing no result, without the CUDA cards the
cell asks for, and 4 where a forbidden module is loaded."""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

# nothing of these may be loaded in the process that prints the result,
# compared by whole top-level module names
FORBIDDEN = ("jax", "jaxlib", "flax", "intmax_zkp_core_tpu")


def forbidden_loaded() -> list:
    return sorted({name.split(".")[0] for name in sys.modules} & set(FORBIDDEN))


class Run:
    """What the metric readers read."""

    def __init__(self, result: dict, stages: dict):
        self.setup_s = result["setup_s"]
        self.window_s = result["window_s"]
        self.memory_peak_bytes = result["memory_peak_bytes"]
        self.record = result["record"]
        self.stages = stages


def metrics(bench: dict, cell: dict, result: dict, trace: bool, base: str | None = None) -> dict:
    """The cell's metrics of this mode, each read by ``metrics/<name>.py``
    under ``base`` (``port_bench/``); a reader that finds nothing to read
    leaves its metric out."""
    from port_bench.harness import cells

    base = base or cells.HERE
    run = Run(result, cells.stages(base))
    chosen = cells.per_layer(bench, cell) if trace else cells.end_to_end(bench, cell)
    out = {}
    for m in chosen:
        value = cells.metric_reader(m["name"], base).read(run)
        if value is not None:
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out


def result_line(bench: dict, cell: dict, result: dict, trace: bool, kind: str, count: int,
                base: str | None = None) -> dict:
    """The result as the last line of standard output carries it; the
    numbers compared come last, each beside its limit."""
    judgement = result["judgement"]
    checks = judgement["checks"]
    line = {
        "correct": all(value <= limit for value, limit in checks.values()),
        "attempted": judgement["attempted"],
        "failed": judgement["failed"],
        "metrics": metrics(bench, cell, result, trace, base),
        "device": {"platform": "gpu", "kind": kind, "count": count,
                   "memory_peak_bytes": result["memory_peak_bytes"]},
    }
    rec = result["record"]
    if trace and rec.trace is not None:
        line["device"]["busy_s"] = rec.trace["busy_s"]
        line["device"]["window_s"] = rec.trace["window_s"]
        line["breakdown"] = {"device_ops": rec.trace["device_ops"],
                             "idle_gaps": rec.trace["idle_gaps"]}
    line["checks"] = {name: {"value": value, "limit": limit}
                      for name, (value, limit) in checks.items()}
    return line


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    from port_bench.harness import cells

    bench = cells.load_bench(ROOT)
    cell = cells.workload(bench, args.workload)
    import torch

    have = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if have < cell["chips"]:
        print(f"the cell {cell['name']} needs {cell['chips']} CUDA device(s); this process "
              f"sees {have}", file=sys.stderr)
        return 3
    devices = [torch.device("cuda", i) for i in range(cell["chips"])]
    from port_bench.harness.window import run_cell

    result = run_cell(bench, cell, args.seed, args.seconds, bool(args.trace), devices, T_START)
    found = forbidden_loaded()
    if found:
        print(f"forbidden modules loaded: {found}", file=sys.stderr)
        return 4
    line = result_line(bench, cell, result, bool(args.trace),
                       torch.cuda.get_device_name(devices[0]), len(devices))
    judgement = result["judgement"]
    print(f"requests={result['requests']} window_s={result['window_s']} "
          f"judge_s={judgement['seconds']}", file=sys.stderr)
    for name, (value, limit) in judgement["checks"].items():
        print(f"check {name}={value} limit={limit}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
