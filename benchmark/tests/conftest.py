"""The benchmark's own tests: ``python -m pytest benchmark/tests`` from the
root of the repository (on the card: ``python -m pytest -m cuda
benchmark/tests``)."""

import os
import sys

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
for path in (BENCH, os.path.dirname(BENCH)):
    if path not in sys.path:
        sys.path.insert(0, path)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA GPU and nvcc; skips without them")
