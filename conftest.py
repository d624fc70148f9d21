"""Repo-wide pytest plugins: tier-1's longest-first schedule for xdist's
``--dist loadfile`` (``tests/tier1_schedule.py``).  The CPU mesh the tests
run on is set up in ``tests/conftest.py``."""

import importlib.util
import pathlib
import sys

_path = pathlib.Path(__file__).resolve().parent / "tests" / "tier1_schedule.py"
_spec = importlib.util.spec_from_file_location("tier1_schedule", _path)
tier1_schedule = sys.modules["tier1_schedule"] = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(tier1_schedule)

pytest_xdist_make_scheduler = tier1_schedule.pytest_xdist_make_scheduler
