"""The traffic: a mix is a data file, ``traffic/<mix>.json``, whose ``kind``
names its generator, ``generators/<kind>.py``, and whose other keys are that
generator's parameters.  A generator's ``requests(mix, rng)`` yields the
requests; everything is drawn from ``rng``, seeded from the run's seed: the
same seed gives the same requests, in the same order, and no input repeats
within a run."""

from __future__ import annotations

import random

from . import cells


def requests(mix: dict, seed, base: str = cells.HERE):
    """The stream of requests of ``mix`` under ``seed`` (an int, or a string
    for a stream apart, such as the set-up's warm requests)."""
    return cells.generator(mix["kind"], base).requests(mix, random.Random(seed))
