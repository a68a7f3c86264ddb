"""The benchmark's own tests: its files and counts on the CPU, its harness
driven at a tiny size on the CPU (the port's plain kernels), and one run
of a cell on the card where there is one (marked `cuda`)."""

import json
import sys
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(BENCH))
sys.path.insert(1, str(BENCH.parent))
DATA = Path(__file__).resolve().parent / "data"


@pytest.fixture
def tiny_cell():
    import harness

    spec = json.loads((DATA / "spec.json").read_text())

    def make(name):
        return harness.Cell(name, spec, DATA)
    return make
