"""pytest settings of the benchmark's own tests (``python -m pytest
port_bench/tests``): the root of the checkout on the path, and the ``cuda``
marker of tests that need a card."""

import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def pytest_configure(config):
    config.addinivalue_line("markers", "cuda: needs a CUDA card; skipped without one")
