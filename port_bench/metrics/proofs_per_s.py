"""Proofs completed in the window over the seconds from its start to the
last completion."""


def read(run):
    proofs = run.record.counts.get("proofs", 0)
    return proofs / run.window_s if proofs and run.window_s > 0 else None
