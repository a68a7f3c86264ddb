"""The result line and what a run refuses: no card, no program, a module
of the JAX stack loaded; the trace reductions on a synthetic trace."""

import json
import os
import subprocess
import sys
import time

import pytest

from conftest import BENCH

ARGS = ["--workload", "gpt2-medium.train", "--seed", str(2 ** 33 + 3),
        "--seconds", "1", "--trace", "0"]


def _cpu_only_env():
    env = dict(os.environ)
    env["CUDA_VISIBLE_DEVICES"] = ""
    return env


def test_no_card_no_result():
    out = subprocess.run([sys.executable, str(BENCH / "run.py"), *ARGS],
                         capture_output=True, text=True, timeout=300,
                         env=_cpu_only_env(), cwd=BENCH.parent)
    assert out.returncode != 0 and out.stdout.strip() == ""


def test_without_the_program_no_result(tmp_path):
    import shutil

    shutil.copytree(BENCH, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__", ".cache"))
    shutil.copy(BENCH.parent / "BENCHMARK.json", tmp_path)
    out = subprocess.run(
        [sys.executable, "-c",
         "import sys; sys.path.insert(0, 'benchmark'); import run, harness; "
         "import importlib; "
         "sys.exit(0 if importlib.util.find_spec('flexflow_tpu_torch') "
         "is None else 1)"],
        capture_output=True, text=True, timeout=120, cwd=tmp_path)
    assert out.returncode == 0, "the copy must not reach the program"
    out = subprocess.run([sys.executable, "benchmark/run.py", *ARGS],
                         capture_output=True, text=True, timeout=300,
                         cwd=tmp_path, env=_cpu_only_env())
    assert out.returncode != 0 and out.stdout.strip() == ""


def test_forbidden_modules_are_compared_whole():
    code = (
        "import sys, types; sys.path.insert(0, %r); import harness\n"
        "import flexflow_tpu_torch\n"
        "assert harness.forbidden_loaded() == [], harness.forbidden_loaded()\n"
        "sys.modules['flexflow_tpu.ops'] = types.ModuleType('x')\n"
        "sys.modules['jaxlib'] = types.ModuleType('y')\n"
        "print(harness.forbidden_loaded())\n" % str(BENCH))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120, cwd=BENCH.parent)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "['flexflow_tpu', 'jaxlib']"


def test_a_tiny_run_loads_no_jax(tiny_cell):
    code = (
        "import sys, json, time; sys.path.insert(0, %r); "
        "sys.path.insert(1, %r)\n"
        "import harness, run\n"
        "from pathlib import Path\n"
        "d = Path(%r)\n"
        "spec = json.loads((d / 'spec.json').read_text())\n"
        "for n in ('tiny.train', 'tiny.serve'):\n"
        "    secs = 1.5 if n.endswith('serve') else 0.1\n"
        "    line = run.run_cell(harness.Cell(n, spec, d), 5, secs, False,\n"
        "                        time.perf_counter(), device='cpu')\n"
        "    assert line['correct']\n"
        "print(harness.forbidden_loaded())\n"
        % (str(BENCH), str(BENCH.parent), str(BENCH / "tests" / "data")))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_result_line_is_json_with_checks_last(tiny_cell):
    import run

    line = run.run_cell(tiny_cell("tiny.train"), 9, 0.1, False,
                        time.perf_counter(), device="cpu")
    line.pop("_readings")
    text = json.dumps(line)
    back = json.loads(text)
    assert list(back)[-1] == "checks"
    for k, c in back["checks"].items():
        assert set(c) == {"value", "limit"}
    for m in back["metrics"].values():
        assert set(m) == {"value", "unit"}


def test_trace_reductions():
    import devtrace

    t = devtrace.Trace(
        kernels=[("k_a", 10.0, 20.0), ("k_b", 15.0, 30.0), ("k_a", 50, 60),
                 ("outside", 200, 300)],
        spans=[("region", 0.0, 100.0), ("fit", 0.0, 40.0),
               ("submit", 40.0, 100.0)], start=0.0, end=100.0)
    assert t.busy_s == pytest.approx(30e-6)
    assert t.window_s == pytest.approx(100e-6)
    gaps = t.idle_gaps()
    assert gaps[0] == ("submit", pytest.approx(40e-6))
    assert ("fit", pytest.approx(10e-6)) in gaps
    assert t.matching([r"^k_a$"]) == (pytest.approx(20e-6), 2)
    b = t.breakdown()
    assert b["device_ops"][0][0] in ("k_a", "k_b") and len(b["idle_gaps"]) == 3


def test_the_loss_is_read_between_the_heads_products():
    """The loss layer's kernels in a captured step, in the order they ran:
    the runs between matrix products that hold a kernel only the loss
    runs, per step; other elementwise work and the optimizer are not
    counted, and a step without such a run reads nothing."""
    import devtrace
    import harness

    loss = harness.load_module("metrics", "train.loss_ms")
    step = [("ln_fwd_rows", 1), ("nvjet_tst_320x128_NNT", 4),
            ("direct_copy_kernel_cuda", 2), ("reduce_kernel", 1),
            ("exp_kernel_cuda", 1), ("log_kernel_cuda", 1),
            ("index_elementwise_kernel", 1),
            ("cutlass_75_tensorop_bf16_s1688gemm_nt_align1", 5),
            ("CUDAFunctor_add", 3), ("sm90_xmma_gemm_bf16", 4),
            ("multi_tensor_apply_kernel", 6)]
    kernels, at = [], 0.0
    for _ in range(2):
        for name, us in step:
            kernels.append((name, at, at + us))
            at += us + 1
    t = devtrace.Trace(kernels=kernels, start=0.0, end=at)
    assert t.runs_holding(harness.patterns("loss"),
                          harness.patterns("gemm")) == (
        pytest.approx(2 * 6e-6), 2)
    assert loss.read({"step_trace": t, "steps": 2}) == pytest.approx(6e-3)
    plain = devtrace.Trace(kernels=[k for k in kernels
                                    if "exp" not in k[0]
                                    and "log" not in k[0]],
                           start=0.0, end=at)
    assert loss.read({"step_trace": plain, "steps": 2}) is None


def test_percentile_counts_failures_as_missing():
    import harness

    assert harness.percentile([1, 2, 3, 4, 5], 50) == 3
    assert harness.percentile(list(range(1, 20)) + [float("inf")], 95) \
        == float("inf")
