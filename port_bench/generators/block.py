"""One block of the flagship flow a request (``bin/block_circuit.rs``): the
two senders' private keys, the merge key, the two contracts and the variable
of their assets, the two recipients, the two amounts, the two transaction
nonces and the amount of the next block's deposit, all drawn from the seed.
The senders' addresses, the contracts and the recipients each part at their
trees' first level (the circuits' trees are ``log_max_n_*`` levels deep), so
no step fails."""

from port_bench.reference.poseidon import P, two_to_one


def _distinct_low_bits(rng, bits: int) -> tuple:
    """Two keys below 2^bits whose paths part at the first level, so that
    every tree of the circuits' depth holds both."""
    a = rng.randrange(1, 1 << bits)
    b = (rng.randrange(1, 1 << bits) & ~1) | (1 - a % 2)  # the other low bit
    return a, b or 2


def requests(mix: dict, rng):
    bits = mix["value_bits"]
    while True:
        while True:
            keys = [tuple(rng.randrange(1, P) for _ in range(4)) for _ in range(2)]
            addrs = [two_to_one(k, k)[0] for k in keys]
            if (addrs[0] ^ addrs[1]) & 1:
                break
        yield {
            "sender_keys": keys,
            "merge_key": rng.randrange(1, 1 << bits),
            "contracts": _distinct_low_bits(rng, bits),
            "variable": rng.randrange(1, 1 << bits),
            "recipients": _distinct_low_bits(rng, bits),
            "amounts": [rng.randrange(1, 1 << bits) for _ in range(2)],
            "nonces": [tuple(rng.randrange(P) for _ in range(4)) for _ in range(2)],
            "deposit_amount": rng.randrange(1, 1 << bits),
        }
