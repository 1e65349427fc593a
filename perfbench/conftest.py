"""pytest settings of the benchmark's own tests: the repository root on the
path, and the ``cuda`` marker of tests that need the card."""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def pytest_configure(config):
    config.addinivalue_line("markers", "cuda: needs an NVIDIA card; skipped without one")
