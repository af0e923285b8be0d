"""The benchmark's own tests: `python -m pytest benchmarks/tests` from the
repo root. They put the benchmark's folder and the repo root on sys.path;
tests marked `gpu` skip themselves without a CUDA card."""

import sys
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(HERE), str(HERE.parent)]


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: needs a CUDA card; the test skips itself without one")
