"""Milliseconds a proof of the prover's eager tensor code: the
``quotient_gates``, ``openings``, ``fri_combine`` and ``fri_fold`` phases of
``prove_batch(timings=)``."""

PARTS = ("quotient_gates", "openings", "fri_combine", "fri_fold")


def read(run):
    proofs = run.record.counts.get("proofs", 0)
    if not proofs or not all(p in run.record.phases for p in PARTS):
        return None
    return sum(run.record.phases[p] for p in PARTS) / proofs * 1e3
