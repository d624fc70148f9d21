"""Seconds a block of the witness fill: the ``witness`` phases of the
block's ``prove_batch`` calls."""


def read(run):
    blocks = run.record.counts.get("blocks", 0)
    fill = run.record.phases.get("witness")
    return fill / blocks if blocks and fill is not None else None
