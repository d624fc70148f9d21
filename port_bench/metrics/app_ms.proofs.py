"""Milliseconds a proof of the application layer's host work: the
benchmark's span around ``SparseMerkleTree.set`` and
``SparseMerkleProcessProofTarget.set_witness``."""


def read(run):
    proofs = run.record.counts.get("proofs", 0)
    app = run.record.spans.get("app")
    return app / proofs * 1e3 if proofs and app is not None else None
