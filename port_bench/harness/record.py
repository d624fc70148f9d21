"""What a run records for its per-layer metrics: spans taken by the
benchmark around its calls into the program, the program's own phase
timings (``prove_batch(timings=)``), counts, and the trace's reduction."""

from __future__ import annotations

import time
from contextlib import contextmanager


class Record:
    def __init__(self):
        self.spans: dict = {}  # name -> seconds, summed over the window
        self.setup_spans: dict = {}  # the same, of the set-up
        self.phases: dict = {}  # prover phase -> seconds, summed over the window
        self.counts: dict = {}  # "proofs", "blocks", "requests", ...
        self.trace: dict | None = None  # harness.trace.reduce's result
        self.work: list = []  # roofline work of the traced requests: (stage, bytes, mads)
        self.in_window = False

    def open_window(self) -> None:
        self.setup_spans, self.spans, self.phases = dict(self.spans), {}, {}
        self.in_window = True

    @contextmanager
    def span(self, name: str):
        """Seconds of the block under ``name``; in a trace the block is the
        host event ``bench:<name>``."""
        from torch.profiler import record_function

        t0 = time.perf_counter()
        try:
            with record_function(f"bench:{name}"):
                yield
        finally:
            self.spans[name] = self.spans.get(name, 0.0) + time.perf_counter() - t0

    def add_phases(self, timings) -> None:
        if timings and self.in_window:
            for k, v in timings.items():
                self.phases[k] = self.phases.get(k, 0.0) + v

    def count(self, name: str, n: int = 1) -> None:
        """Counts are of the window only."""
        if self.in_window:
            self.counts[name] = self.counts.get(name, 0) + n
