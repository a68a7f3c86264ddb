"""The readings that set a cell's correctness limits: one run of the cell
at a short window, then beside the program's numbers the control's (the
reference one precision step below the program's, fp8 products for its
bfloat16) and, for training, a planted fault's (the loss's mean over half
the batch), each compared with the reference as the run compares the
program.

    python3 benchmark/readings.py --workload <cell> --seed <n> \
        [--seconds 2] [--variants control,half_batch]

prints one JSON line: the seed, every set of numbers, and whether each
comes out correct under the cell's limits by the harness's own
comparison (`harness.is_correct`). The benchmark's own runs never
compute these.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
sys.path.insert(0, str(HERE))
sys.path.insert(1, str(HERE.parent))


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, default=2.0)
    p.add_argument("--variants", default="control")
    args = p.parse_args(argv)
    import harness
    import run

    run._cache_dirs()
    cell = harness.Cell(args.workload)
    variants = tuple(v for v in args.variants.split(",") if v)
    result = cell.kind().run(cell, args.seed, args.seconds, False, T_START,
                               variants=variants)
    nums = result["numbers"]
    program = {k: v for k, v in nums.items() if k not in variants}
    sets = {"program": program, **{v: nums[v] for v in variants}}
    print(json.dumps({
        "workload": args.workload, "seed": args.seed, **sets,
        "correct": {k: harness.is_correct(v, cell.limits)
                    for k, v in sets.items()},
        "readings": result.get("readings"),
        "window": {k: v for k, v in result["window"].items()
                   if isinstance(v, (int, float))}}, default=float),
        flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
