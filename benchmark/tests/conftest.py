"""The benchmark's own tests: ``python -m pytest benchmark/tests`` from the
root of the repository.  They run on the CPU at small sizes; the tests
marked ``card`` need a CUDA device and skip without one."""

import os
import sys

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH)
for path in (ROOT, BENCH):
    if path not in sys.path:
        sys.path.insert(0, path)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs a CUDA device (skips without one)")
