"""The traffic generators are functions of the seed: the same seed gives the
same requests, another seed others, the warm-up stream is apart, and no
input repeats within a run."""

import itertools

import pytest

from port_bench.harness import cells, traffic


def take(mix, seed, n):
    return list(itertools.islice(traffic.requests(mix, seed), n))


def inputs(mix, requests):
    """The inputs of a run's requests, each as one hashable item."""
    if mix["kind"] == "smt_set":
        return [step for batch in requests for step in batch]
    return [tuple(map(tuple, r["sender_keys"])) + tuple(map(tuple, r["nonces"]))
            for r in requests]


@pytest.mark.parametrize("name,n", [("smt_k32", 20), ("block_one", 20)])
def test_mixes_are_seeded(name, n):
    mix = cells.mix(name)
    seed = 2**31 + 12345  # a seed may pass 32 signed bits
    a, b = take(mix, seed, n), take(mix, seed, n)
    assert a == b
    assert a != take(mix, seed + 1, n)
    assert take(mix, f"{seed}:warm", 1)[0] not in a
    items = inputs(mix, a)
    assert len(set(items)) == len(items)  # no input repeats


def test_smt_steps_in_range():
    mix = cells.mix("smt_k32")
    batches = take(mix, 2**33 + 1, 10)
    assert all(len(batch) == mix["batch"] for batch in batches)
    assert all(0 <= k < 1 << mix["key_bits"] and any(v) for batch in batches for k, v in batch)
