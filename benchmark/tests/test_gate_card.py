"""One traced run of each cell on the card, where there is one: the line's
schema, `correct`, and every per-layer metric the cell lists present.
Skipped on a machine without a CUDA device (decided inside the test)."""

import json
import subprocess
import sys

import pytest

from conftest import BENCH

SPEC = json.loads((BENCH.parent / "BENCHMARK.json").read_text())


@pytest.mark.cuda
@pytest.mark.parametrize("workload", [w["name"] for w in SPEC["workloads"]
                                      if w["chips"] == 1])
def test_a_traced_run_on_the_card(workload):
    import torch

    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: the cells run on the card")
    out = subprocess.run(
        [sys.executable, str(BENCH / "run.py"), "--workload", workload,
         "--seed", str(2 ** 32 + 77), "--seconds", "3", "--trace", "1"],
        capture_output=True, text=True, timeout=900, cwd=BENCH.parent)
    assert out.returncode == 0, out.stderr[-4000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["correct"], line["checks"]
    assert line["device"]["busy_s"] > 0
    listed = {m["name"] for m in SPEC["per_layer"]
              if workload in m.get("workloads", [workload])}
    assert listed <= set(line["metrics"])
