"""Run one cell of the benchmark once and print its result line.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

The cell's files are found by the names in BENCHMARK.json (see
harness.py). The last line of standard output is one JSON object:
`correct`, `attempted`, `failed`, `metrics`, `device`, with `--trace 1`
also `breakdown`, and last `checks`, each number compared with its limit;
the same numbers end standard error. A run exits non-zero and prints no
result when the card is missing or too few, when the checkout holds no
program, or when a module of the JAX stack or the JAX package is loaded
once the window has closed. A cell on more than one chip is started as
one process per card (launcher.py), and rank 0's line is printed.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
CHECKOUT = HERE.parent
sys.path.insert(0, str(HERE))
sys.path.insert(1, str(CHECKOUT))


def parse(argv):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def _cache_dirs():
    """Every build and kernel cache at a fixed path inside the checkout
    (the program builds its CUDA kernels into its own `_build/` there)."""
    cache = HERE / ".cache"
    os.environ.setdefault("TORCH_EXTENSIONS_DIR", str(cache / "torch_ext"))
    os.environ.setdefault("TRITON_CACHE_DIR", str(cache / "triton"))
    # a library that would load JAX by itself is kept from doing so
    os.environ.setdefault("USE_FLAX", "0")
    os.environ.setdefault("USE_JAX", "0")


def run_cell(cell, seed: int, seconds: float, trace: bool, t_start: float,
             device: str = "cuda") -> dict:
    """Drive one run of `cell` and return the result line as a dict. The
    chip check is the caller's: tests call this on the CPU."""
    import harness

    result = cell.kind().run(cell, seed, seconds, trace, t_start,
                             device=device)
    metrics = harness.result_metrics(cell, result, trace)
    checks = harness.checks_block(result["numbers"], cell.limits)
    import torch

    traced = result["traced"]
    busy = window = None
    out_breakdown = None
    if trace and traced:
        st = traced["step_trace"]
        busy, window = st.busy_s, st.window_s
        out_breakdown = st.breakdown()
    line = {
        "correct": harness.is_correct(result["numbers"], cell.limits),
        "attempted": int(result["attempted"]),
        "failed": int(result["failed"]),
        "metrics": metrics,
        "device": (harness.device_record(torch, cell.chips,
                                         result["peak_bytes"], busy, window)
                   if device == "cuda" else {"platform": "cpu",
                                             "count": cell.chips,
                                             "memory_peak_bytes": 0}),
    }
    if out_breakdown is not None:
        line["breakdown"] = out_breakdown
    line["checks"] = checks
    line["_readings"] = result.get("readings")
    return line


def main(argv=None) -> int:
    args = parse(sys.argv[1:] if argv is None else argv)
    _cache_dirs()
    import harness

    cell = harness.Cell(args.workload)
    import torch

    if not torch.cuda.is_available():
        print("no CUDA device: this benchmark measures the card",
              file=sys.stderr)
        return 2
    if torch.cuda.device_count() < cell.chips:
        print(f"{args.workload} needs {cell.chips} cards, "
              f"{torch.cuda.device_count()} visible", file=sys.stderr)
        return 2
    if cell.chips > 1 and "RANK" not in os.environ:
        import launcher

        return launcher.launch(Path(__file__).resolve(),
                               sys.argv[1:] if argv is None else argv,
                               cell.chips)
    line = run_cell(cell, args.seed, args.seconds, bool(args.trace), T_START)
    found = harness.forbidden_loaded()
    if found:
        print(f"modules that may not be loaded in a run: {found}",
              file=sys.stderr)
        return 3
    if int(os.environ.get("RANK", "0")) != 0:
        return 0
    readings = line.pop("_readings", None)
    if readings is not None:
        print("readings " + json.dumps(readings, default=float),
              file=sys.stderr)
    harness.print_checks(line["checks"])
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
