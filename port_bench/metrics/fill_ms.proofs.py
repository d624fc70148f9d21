"""Milliseconds a proof of the witness fill: the ``witness`` phase of
``prove_batch(timings=)``."""


def read(run):
    proofs = run.record.counts.get("proofs", 0)
    fill = run.record.phases.get("witness")
    return fill / proofs * 1e3 if proofs and fill is not None else None
