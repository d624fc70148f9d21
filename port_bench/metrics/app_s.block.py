"""Seconds a block of the application layer's host work: the benchmark's
spans around the scenario's calls into the rollup, transaction and zkDSA
models (trees, headers, the three circuits' ``set_witness``)."""


def read(run):
    blocks = run.record.counts.get("blocks", 0)
    app = run.record.spans.get("app")
    return app / blocks if blocks and app is not None else None
