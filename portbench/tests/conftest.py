"""The harness's own tests: CPU tests at tiny sizes, and tests marked
``gpu`` that skip without a CUDA card (each decides inside itself)."""

import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def pytest_configure(config):
    config.addinivalue_line("markers",
                            "gpu: needs a CUDA device; skips without one")

