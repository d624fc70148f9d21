"""Seconds a block of the prover's eager tensor code: the
``quotient_gates``, ``openings``, ``fri_combine`` and ``fri_fold`` phases of
the block's ``prove_batch`` calls."""

PARTS = ("quotient_gates", "openings", "fri_combine", "fri_fold")


def read(run):
    blocks = run.record.counts.get("blocks", 0)
    if not blocks or not all(p in run.record.phases for p in PARTS):
        return None
    return sum(run.record.phases[p] for p in PARTS) / blocks
