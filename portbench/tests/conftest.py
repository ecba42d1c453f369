"""Tests of the benchmark harness.  They run on the CPU; a test that needs
the card carries the ``cuda`` marker and decides inside itself whether a
card is there.  Run them with ``python -m pytest portbench/tests -q``."""

import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA GPU (skips without one)")
