"""Longest-first work units for xdist's ``--dist loadfile``.

xdist orders loadfile's units (files) by number of tests, largest first, so
the slowest files, which have few tests, start last and the run ends long
after the mean worker.  Here a test whose measured seconds reach OWN_UNIT_S
is a unit of its own, and the units go out longest first by the seconds
recorded in tier1_seconds.json (refresh it from a run with
``--durations=0``).  A test the file does not name keeps its file's unit,
and a unit with nothing recorded keeps xdist's place for it, after the
timed ones, by number of tests.

The long tests slow one another: started all at once on 6 workers of an
8-core host they took 48 % more worker time in all than in xdist's order,
and the longest 46 % more.  So at most MAX_OWN_UNITS of them run at a time.

The repo's root ``conftest.py`` registers the hook below; it is not called
without xdist, and returns ``None`` (xdist's own scheduler) for any other
mode.
"""

import json
import pathlib

import pytest

SECONDS_FILE = pathlib.Path(__file__).with_name("tier1_seconds.json")
OWN_UNIT_S = 100.0
MAX_OWN_UNITS = 3


def recorded_seconds() -> dict:
    """Node id -> measured seconds of each slow test."""
    return json.loads(SECONDS_FILE.read_text())["tests"]


def unit_of(nodeid: str, seconds: dict) -> str:
    """The work unit of a test: the test itself when it takes OWN_UNIT_S or
    more, else its file (xdist's loadfile unit)."""
    if seconds.get(nodeid, 0.0) >= OWN_UNIT_S:
        return nodeid
    return nodeid.split("::", 1)[0]


def longest_first(units: dict, seconds: dict) -> list:
    """The units' names, most recorded seconds first; ties (units with
    nothing recorded) by number of tests, largest first, then in the order
    given, as xdist orders them."""
    return sorted(units, key=lambda u: (-sum(seconds.get(n, 0.0) for n in units[u]),
                                        -len(units[u])))


def next_unit(units: dict, pending: list, own_running: int, seconds: dict) -> str:
    """The unit to hand a worker whose unfinished tests are ``pending``,
    while workers hold ``own_running`` unfinished units of one test.

    A worker must know its next test before it runs one, so xdist queues a
    unit behind the one running.  Behind a test of OWN_UNIT_S or more that
    unit waits: it is the shortest.  Any other worker is about to be free
    and takes the longest, but a file while MAX_OWN_UNITS tests of their
    own are out."""
    order = longest_first(units, seconds)
    if sum(seconds.get(n, 0.0) for n in pending) >= OWN_UNIT_S:
        return order[-1]
    if own_running >= MAX_OWN_UNITS:
        files = [u for u in order if "::" not in u]
        if files:
            return files[0]
    return order[0]


@pytest.hookimpl(optionalhook=True)
def pytest_xdist_make_scheduler(config, log):
    if config.getvalue("dist") != "loadfile":
        return None
    from xdist.scheduler import LoadFileScheduling

    seconds = recorded_seconds()

    class LongestFirstScheduling(LoadFileScheduling):
        def _split_scope(self, nodeid):
            return unit_of(nodeid, seconds)

        def _assign_work_unit(self, node):
            # xdist assigns the queue's first unit: put the chosen one there.
            pending = [n for unit in self.assigned_work[node].values()
                       for n, done in unit.items() if not done]
            own_running = sum("::" in name and not all(unit.values())
                              for work in self.assigned_work.values()
                              for name, unit in work.items())
            unit = next_unit(self.workqueue, pending, own_running, seconds)
            self.workqueue.move_to_end(unit, last=False)
            super()._assign_work_unit(node)

    return LongestFirstScheduling(config, log)
