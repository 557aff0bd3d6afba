"""The benchmark's own tests: ``python -m pytest portbench/tests -q`` from
the root of the checkout.  Tests marked ``cuda`` need the card and skip
without one."""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs a CUDA card; skips on a host without one")
