"""The benchmark's own CPU tests: ``python3 -m pytest portbench/tests``.
A test that needs the card carries the marker ``cuda`` and skips here."""

import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if REPO not in sys.path:
    sys.path.insert(0, REPO)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs a CUDA card; skips where there is none")
