"""Seconds of the window (its start to the last completion) over the blocks
completed in it."""


def read(run):
    blocks = run.record.counts.get("blocks", 0)
    return run.window_s / blocks if blocks else None
