"""The longest-first schedule of ``--dist loadfile`` (``tier1_schedule.py``): its
units, their order, and the measured seconds it reads
(``tier1_seconds.json``).  Fake node ids; no xdist session."""

import ast
import pathlib
import types

import pytest

import tier1_schedule as schedule

SLOW = schedule.OWN_UNIT_S

IDS = [
    "tests/test_a.py::test_one",
    "tests/test_a.py::test_two",
    "tests/test_a.py::test_three",
    "tests/test_b.py::test_slow",
    "tests/test_b.py::test_fast[1]",
    "tests/test_b.py::test_fast[2]",
    "tests/test_c.py::test_only",
    "tests/test_d.py::test_x",
    "tests/test_d.py::test_y",
]
SECONDS = {
    "tests/test_b.py::test_slow": SLOW + 200.0,
    "tests/test_c.py::test_only": SLOW - 10.0,
    "tests/test_d.py::test_x": 40.0,
}


def _units(ids, seconds):
    units = {}
    for nodeid in ids:
        units.setdefault(schedule.unit_of(nodeid, seconds), []).append(nodeid)
    return units


def test_slow_test_is_its_own_unit_and_its_file_stays_together():
    units = _units(IDS, SECONDS)
    assert units["tests/test_b.py::test_slow"] == ["tests/test_b.py::test_slow"]
    assert units["tests/test_b.py"] == ["tests/test_b.py::test_fast[1]",
                                        "tests/test_b.py::test_fast[2]"]
    # under the threshold: the file's unit, as xdist's loadfile has it
    assert units["tests/test_c.py"] == ["tests/test_c.py::test_only"]
    assert units["tests/test_d.py"] == ["tests/test_d.py::test_x", "tests/test_d.py::test_y"]


def test_unrecorded_test_keeps_its_file_unit():
    assert schedule.unit_of("tests/test_b.py::test_new", SECONDS) == "tests/test_b.py"
    assert schedule.unit_of("tests/test_b.py::test_slow_renamed", SECONDS) == "tests/test_b.py"


def test_longest_unit_first_then_by_number_of_tests():
    order = schedule.longest_first(_units(IDS, SECONDS), SECONDS)
    assert order == ["tests/test_b.py::test_slow", "tests/test_c.py", "tests/test_d.py",
                     "tests/test_a.py", "tests/test_b.py"]
    # nothing recorded: xdist's own order, most tests first
    assert schedule.longest_first(_units(IDS, {}), {}) == [
        "tests/test_a.py", "tests/test_b.py", "tests/test_d.py", "tests/test_c.py"]


def test_every_test_lands_in_exactly_one_unit():
    seconds = schedule.recorded_seconds()
    ids = IDS + sorted(seconds)
    units = _units(ids, seconds)
    placed = [nodeid for unit in units.values() for nodeid in unit]
    assert sorted(placed) == sorted(ids)


class _Node:
    shutting_down = False

    def __init__(self, name):
        self.gateway = types.SimpleNamespace(id=name)
        self.sent = []

    def send_runtest_some(self, indices):
        self.sent.append(indices)

    def shutdown(self):
        self.shutting_down = True


def _config(dist, n_workers=2):
    values = {"dist": dist, "tx": [f"{n_workers}*popen"]}
    return types.SimpleNamespace(getvalue=values.__getitem__,
                                 option=types.SimpleNamespace(loadscopereorder=True))


def test_the_unit_behind_a_long_test_is_the_shortest():
    units = _units(IDS, SECONDS)
    assert schedule.next_unit(units, [], 0, SECONDS) == "tests/test_b.py::test_slow"
    assert schedule.next_unit(units, ["tests/test_d.py::test_x"], 0, SECONDS) == (
        "tests/test_b.py::test_slow")
    assert schedule.next_unit(units, ["tests/test_b.py::test_slow"], 0, SECONDS) == (
        "tests/test_b.py")


def test_a_file_goes_while_enough_long_tests_run():
    units = _units(IDS, SECONDS)
    cap = schedule.MAX_OWN_UNITS
    assert schedule.next_unit(units, [], cap - 1, SECONDS) == "tests/test_b.py::test_slow"
    assert schedule.next_unit(units, [], cap, SECONDS) == "tests/test_c.py"
    only_long = {"tests/test_b.py::test_slow": ["tests/test_b.py::test_slow"]}
    assert schedule.next_unit(only_long, [], cap, SECONDS) == "tests/test_b.py::test_slow"


def test_scheduler_hands_out_the_longest_unit_first(monkeypatch):
    monkeypatch.setattr(schedule, "recorded_seconds", lambda: SECONDS)
    sched = schedule.pytest_xdist_make_scheduler(_config("loadfile"), log=None)
    nodes = [_Node("gw0"), _Node("gw1")]
    for node in nodes:
        sched.add_node(node)
        sched.add_node_collection(node, IDS)
    sched.schedule()
    sent = [[[IDS[i] for i in batch] for batch in node.sent] for node in nodes]
    assert sent == [
        [["tests/test_b.py::test_slow"],
         ["tests/test_b.py::test_fast[1]", "tests/test_b.py::test_fast[2]"]],  # the shortest
        [["tests/test_c.py::test_only"], ["tests/test_d.py::test_x", "tests/test_d.py::test_y"]],
    ]
    assert list(sched.workqueue) == ["tests/test_a.py"]


def test_scheduler_counts_the_long_tests_out(monkeypatch):
    seconds = dict(SECONDS, **{"tests/test_e.py::test_slow": SLOW + 100.0})
    ids = IDS + ["tests/test_e.py::test_slow"]
    monkeypatch.setattr(schedule, "recorded_seconds", lambda: seconds)
    monkeypatch.setattr(schedule, "MAX_OWN_UNITS", 1)
    sched = schedule.pytest_xdist_make_scheduler(_config("loadfile", 3), log=None)
    nodes = [_Node(f"gw{i}") for i in range(3)]
    for node in nodes:
        sched.add_node(node)
        sched.add_node_collection(node, ids)
    sched.schedule()
    sent = [[ids[i] for batch in node.sent for i in batch] for node in nodes]
    assert sent == [
        ["tests/test_b.py::test_slow", "tests/test_b.py::test_fast[1]",
         "tests/test_b.py::test_fast[2]"],
        ["tests/test_c.py::test_only", "tests/test_a.py::test_one", "tests/test_a.py::test_two",
         "tests/test_a.py::test_three"],
        # the second long test only once no file is left
        ["tests/test_d.py::test_x", "tests/test_d.py::test_y", "tests/test_e.py::test_slow"],
    ]


@pytest.mark.parametrize("dist", ["load", "loadscope", "each", "no"])
def test_other_modes_keep_xdists_scheduler(dist):
    assert schedule.pytest_xdist_make_scheduler(_config(dist), log=None) is None


def test_recorded_tests_exist():
    """Every recorded id names a test function of a file of tests/, so a
    renamed or deleted test shows here."""
    seconds = schedule.recorded_seconds()
    assert seconds
    root = pathlib.Path(schedule.__file__).resolve().parent.parent
    for nodeid, s in seconds.items():
        assert s >= 0.0, nodeid
        path, _, name = nodeid.partition("::")
        file = root / path
        assert file.is_file(), nodeid
        tree = ast.parse(file.read_text())
        names = {f"{c.name}::{f.name}" for c in tree.body if isinstance(c, ast.ClassDef)
                 for f in c.body if isinstance(f, ast.FunctionDef)}
        names |= {f.name for f in tree.body if isinstance(f, ast.FunctionDef)}
        assert name.split("[", 1)[0] in names, nodeid
