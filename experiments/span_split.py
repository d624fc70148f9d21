#!/usr/bin/env python3
"""Where a traced request of a benchmark cell spends its time, read from the
program's own spans (``intmax_zkp_core_tpu_torch/engine/spans.py``).

    python3 experiments/span_split.py --workload smt256.batch32 --seed 7 --requests 6

Runs one cell of ``port_bench`` as its traced run does -- the set-up with
its warm request, then ``--requests`` requests of the cell's traffic under
``--seed``, the second and third profiled by ``torch.profiler``
(``port_bench/harness/trace.py``: ``start``, ``stop``) -- with every request
after the set-up served inside ``spans.recording()``, so that the prover's
spans also open profiler ranges.  For the profiled requests, and apart for
the others (whose times the profiler does not inflate), it prints per proof
(a batch cell) or per block (the block cell):

* ``split``: the host's time by the innermost span open -- ``bench:app``,
  each ``prover:`` span's self time, ``bench:prove`` outside any program
  span, and ``none`` outside every span -- which adds up to the requests'
  wall time;
* ``metrics``: ``app``, ``fill`` (the ``witness`` phase), ``tensor``
  (``quotient_gates`` + ``openings`` + ``fri_combine`` + ``fri_fold``), as
  the benchmark reads them; ``transcript`` (self time of
  ``prover:transcript``, its fetches excluded), ``host_wait`` (the counter
  ``fetch_s``), ``fetches`` and ``idle_launch_pct``, the share of the
  profiled window in which the card idles while the innermost span open on
  the host is a device phase or part (not ``witness``, ``tables``,
  ``transcript`` or ``fetch``): the host running eager tensor code more
  slowly than the card runs it (profiled requests);
* ``transcript_by_place``: the self time of ``prover:transcript`` by the
  phase or part it sits in, and ``phases``, the ``timings=`` of the prover;
* ``idle``: the card's idle seconds by the innermost span open on the host
  at each instant, on the profiler's clock, and their share under a
  ``prover:`` span or ``bench:app`` (profiled requests);
* ``trace``: ``busy_s``, ``window_s`` and ``device_idle_pct`` with the
  device-side ranges of both ``bench:`` and ``prover:`` spans skipped, and,
  for comparison, ``busy_s`` as ``trace.reduce`` reads it, which skips only
  ``bench:``.

``--config`` runs another configuration file of the same system, ``--mix``
another traffic mix, and ``--cpu`` the CPU (a rehearsal: no device trace,
times of the CPU).  The last line is one JSON object.  Exits 3 without a
CUDA card.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

import torch  # noqa: E402

from intmax_zkp_core_tpu_torch.engine import spans  # noqa: E402

PROFILED = (1, 3)  # the requests ``port_bench/harness/window.py`` profiles
RANGES = ("bench:", "prover:")
HOST_ONLY = ("prover:tables", "prover:witness", spans.TRANSCRIPT, spans.FETCH)
TENSOR = ("quotient_gates", "openings", "fri_combine", "fri_fold")


def segments(ranges) -> list:
    """Properly nested ranges [(start, end, name)] of one thread -> the
    contiguous segments [(a, b, name)] from the first start to the last end,
    each named by the innermost range open in it (None in none)."""
    out, stack, cur = [], [], None

    def run_to(t):
        nonlocal cur
        while stack and stack[-1][0] <= t:
            end, name = stack.pop()
            if end > cur:
                out.append((cur, end, name))
                cur = end
        if t > cur:
            out.append((cur, t, stack[-1][1] if stack else None))
            cur = t

    for a, b, name in sorted(ranges, key=lambda r: (r[0], -r[1])):
        if cur is None:
            cur = a
        run_to(a)
        stack.append((b, name))
    if stack:
        run_to(max(end for end, _ in stack))
    return out


def idle_intervals(busy, t0, t1) -> list:
    """[t0, t1] less the union of the intervals ``busy``."""
    out, cur = [], t0
    for a, b in sorted(busy):
        if a > cur:
            out.append((cur, min(a, t1)))
        cur = max(cur, b)
    if cur < t1:
        out.append((cur, t1))
    return [(a, b) for a, b in out if b > a]


def idle_by_span(idle, segs) -> dict:
    """Seconds of the intervals ``idle`` under each segment's name (both
    sorted, in the same unit); what no segment covers goes under None."""
    out: dict = {}
    j = 0
    for a, b in idle:
        while j < len(segs) and segs[j][1] <= a:
            j += 1
        covered, k = 0.0, j
        while k < len(segs) and segs[k][0] < b:
            x, y = max(a, segs[k][0]), min(b, segs[k][1])
            if y > x:
                out[segs[k][2]] = out.get(segs[k][2], 0.0) + (y - x)
                covered += y - x
            k += 1
        if b - a > covered:
            out[None] = out.get(None, 0.0) + (b - a - covered)
    return out


def reduce(events, spin: str = "spin_kernel") -> dict:
    """A stopped profiler's events -> the window, the card's busy time with
    both kinds of device-side range skipped, and its idle seconds by the
    innermost span open on the host (microseconds in, seconds out)."""
    dev, host, ranges = [], [], []
    spin_end = 0.0
    cuda = torch.autograd.DeviceType.CUDA
    for ev in events:
        a, b = ev.time_range.start, ev.time_range.end
        if ev.device_type == cuda:
            if spin in ev.name:
                spin_end = max(spin_end, b)
            elif not ev.name.startswith(RANGES):
                dev.append((a, b))
        else:
            host.append((a, b))
            if ev.name.startswith(RANGES):
                ranges.append((a, b, ev.name, ev.thread))
    dev = [d for d in dev if d[0] >= spin_end]
    host = [h for h in host if h[0] >= spin_end]
    if not dev:
        return {}
    t0 = min([a for a, _ in dev] + [a for a, _ in host])
    t1 = max([b for _, b in dev] + [b for _, b in host])
    idle = idle_intervals(dev, t0, t1)
    ranges = [r for r in ranges if r[1] >= spin_end]
    main = next((th for _, _, name, th in ranges if name == "bench:prove"), None)
    segs = segments([(a, b, name) for a, b, name, th in ranges if th == main])
    by = idle_by_span(idle, segs)
    window = (t1 - t0) * 1e-6
    idle_s = sum(b - a for a, b in idle) * 1e-6
    return {"window_s": window, "busy_s": window - idle_s, "idle_s": idle_s,
            "idle": {str(k): v * 1e-6 for k, v in sorted(by.items(), key=lambda kv: -kv[1])}}


def idle_launch_s(idle: dict) -> float:
    """Idle seconds under a device phase or part: a ``prover:`` span that is
    not ``tables``, ``witness``, ``transcript`` or ``fetch``."""
    return sum(v for k, v in idle.items() if k.startswith("prover:") and k not in HOST_ONLY)


class Group:
    """What the requests of one kind (profiled, or not) recorded: the
    program's spans and counters, and the benchmark's ``Record`` before and
    after each request."""

    def __init__(self):
        self.spans, self.counters, self.wall = [], {}, 0.0
        self.record: dict = {}  # "spans" / "phases" / "counts" -> name -> sum

    def add(self, rec, before: dict, wall: float, recorder) -> None:
        self.wall += wall
        got, counters = recorder.take()
        self.spans += got
        for k, v in counters.items():
            self.counters[k] = self.counters.get(k, 0) + v
        for key, was in before.items():
            into = self.record.setdefault(key, {})
            for name, v in getattr(rec, key).items():
                into[name] = into.get(name, 0) + v - was.get(name, 0)

    def summary(self) -> dict:
        """Per proof, or per block: the host's split by innermost span, the
        metrics, the transcript by the phase it sits in, the phases."""
        rec = self.record
        blocks = rec["counts"].get("blocks", 0)
        unit, n = ("block", blocks) if blocks else ("proof", rec["counts"].get("proofs", 0))
        own = spans.self_seconds(self.spans)
        app_s, prove_s = rec["spans"].get("app", 0.0), rec["spans"].get("prove", 0.0)
        split = {"bench:app": app_s, **own,
                 "bench:prove (no program span)": prove_s - sum(own.values()),
                 "none": self.wall - app_s - prove_s}
        places: dict = {}
        for sp in self.spans:
            if sp.name == spans.TRANSCRIPT:
                kids = sum(c.end - c.start for c in self.spans if c.parent is sp)
                places[sp.parent.name] = places.get(sp.parent.name, 0.0) + sp.end - sp.start - kids

        def per(d):
            return {k: v / n for k, v in sorted(d.items(), key=lambda kv: -kv[1])}

        return {
            "per": unit, "count": n, "wall_s": self.wall, "split": per(split),
            "metrics": {
                "app": app_s / n, "fill": rec["phases"].get("witness", 0.0) / n,
                "tensor": sum(rec["phases"].get(p, 0.0) for p in TENSOR) / n,
                "transcript": own.get(spans.TRANSCRIPT, 0.0) / n,
                "host_wait": self.counters.get("fetch_s", 0.0) / n,
                "fetches": self.counters.get("fetches", 0) / n,
            },
            "transcript_by_place": per(places),
            "phases": per(rec["phases"]),
        }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--requests", type=int, default=PROFILED[1])
    ap.add_argument("--config", help="a configuration file in place of the cell's")
    ap.add_argument("--mix", help="a traffic mix, as JSON, in place of the cell's")
    ap.add_argument("--cpu", action="store_true")
    args = ap.parse_args(argv)

    from port_bench.harness import cells, traffic, window
    from port_bench.harness import trace as tr
    from port_bench.harness.record import Record

    bench = cells.load_bench(ROOT)
    cell = cells.workload(bench, args.workload)
    if args.config:
        with open(args.config) as fh:
            cfg = json.load(fh)
    else:
        cfg = cells.config(bench, cell["config"], ROOT)
    if args.cpu:
        device = torch.device("cpu")
    elif torch.cuda.is_available():
        device = torch.device("cuda", 0)
    else:
        print("no CUDA card", file=sys.stderr)
        return 3
    mix = json.loads(args.mix) if args.mix else cells.mix(cell["traffic"])
    rec = Record()
    system = cells.system(cfg).System(cfg, [device], window.circuit_cache_dir(ROOT), rec, True)
    system.setup(traffic.requests(mix, f"{args.seed}:warm"))
    setup_s = time.perf_counter() - T_START
    requests = traffic.requests(mix, args.seed)
    rec.open_window()
    groups = {"profiled": Group(), "unprofiled": Group()}
    prof = profiled = None
    for i in range(args.requests):
        req = next(requests)
        if i == PROFILED[0] and device.type == "cuda":
            prof = tr.start()
        before = {key: dict(getattr(rec, key)) for key in ("spans", "phases", "counts")}
        t0 = time.perf_counter()
        with spans.recording() as r:
            system.serve(req)
        wall = time.perf_counter() - t0
        groups["profiled" if PROFILED[0] <= i < PROFILED[1] else "unprofiled"].add(
            rec, before, wall, r)
        if prof is not None and i + 1 == PROFILED[1]:
            profiled, prof = tr.stop(prof), None

    out = {"workload": args.workload, "seed": args.seed, "device": str(device),
           "name": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
           "setup_s": setup_s}
    out.update({name: g.summary() for name, g in groups.items() if g.wall})
    if profiled is not None:
        n = out["profiled"]["count"]
        red = reduce(profiled.events())
        idle = red["idle"]
        launch = idle_launch_s(idle)
        named = sum(v for k, v in idle.items() if k.startswith("prover:") or k == "bench:app")
        out["profiled"]["metrics"]["idle_launch_pct"] = 100.0 * launch / red["window_s"]
        out["idle"] = {"by_span": {k: v / n for k, v in idle.items()},
                       "share_under_program_or_app": named / red["idle_s"],
                       "share_under_no_span": idle.get("None", 0.0) / red["idle_s"]}
        out["trace"] = {"busy_s": red["busy_s"], "window_s": red["window_s"],
                        "device_idle_pct": 100.0 * red["idle_s"] / red["window_s"],
                        "busy_s_as_trace_reduce_reads": tr.reduce(profiled)["busy_s"]}
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
