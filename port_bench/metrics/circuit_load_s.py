"""Seconds of the set-up's ``load_or_build`` of the cell's circuits (a load
from the circuit cache, or the first run's build)."""


def read(run):
    return run.record.setup_spans.get("circuit_load")
