"""The benchmark's CPU tests: ``python3 -m pytest -p no:cacheprovider
perfbench/tests`` from the root of the repository. Tests that need the
card carry the ``cuda`` marker and decide inside the test whether a card
is there."""

import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA GPU and nvcc; skips elsewhere")
