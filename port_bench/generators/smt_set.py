"""Batches of ``batch`` steps of the reference loop's own mix
(``bin/verify_smt_process.rs``): a random key below 2^key_bits set to a
random value of four field elements, an insert, or an update where the key
is already set."""

P = 0xFFFFFFFF00000001


def requests(mix: dict, rng):
    while True:
        yield [(rng.randrange(1 << mix["key_bits"]), tuple(rng.randrange(P) for _ in range(4)))
               for _ in range(mix["batch"])]
