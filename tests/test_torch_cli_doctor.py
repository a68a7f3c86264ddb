"""The port's post-mortem CLIs — `run_doctor_torch.py` and
`check_warmstart_torch.py` — against the JAX package's
`scripts/run_doctor.py` and `scripts/check_warmstart.py`, on the CPU.

- run_doctor: a healthy and a dead (NaN-aborted) MLP fit under
  `--diagnostics` in each package; each CLI on each package's directory
  prints the same `--json` document as the other CLI on that directory
  and exits with the same code under `--check` and `--check --strict`;
  a strategy report whose total no longer reproduces under the makespan
  rule fails `--check` in both, and a missing directory exits 2 in both;
- check_warmstart: a cold and a warm port fit against one
  `--warmstart-dir` on 2 gloo ranks (the search runs on a mesh of two),
  each with its own `--telemetry-dir`: both CLIs pass on (cold, warm)
  and fail on the swapped pair.

Exact equality (the documents, the exit codes).
"""

import contextlib
import importlib.util
import io
import json
import os
import shutil
import sys

import numpy as np
import pytest
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKGS = ("flexflow_tpu", "flexflow_tpu_torch")


def _load(path: str, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _cli(which: str, name: str, argv) -> tuple:
    """(exit code, stdout) of one package's CLI in this process."""
    path = (os.path.join(REPO, f"{name}_torch.py") if which == "port"
            else os.path.join(REPO, "scripts", f"{name}.py"))
    mod = _load(path, f"{which}_{name}_under_test")
    out, err = io.StringIO(), io.StringIO()
    old = sys.argv
    sys.argv = [name, *argv]
    try:
        with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
            rc = mod.main(list(argv)) if which == "port" else mod.main()
    except SystemExit as e:
        rc = e.code
    finally:
        sys.argv = old
    return int(rc or 0), out.getvalue()


@pytest.fixture(scope="module")
def doctor_dirs(tmp_path_factory):
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from test_torch_diagnostics import _run

    root = tmp_path_factory.mktemp("doctor")
    dirs = {}
    for pkg in PKGS:
        for poison in (False, True):
            d = root / f"{pkg}_{'dead' if poison else 'healthy'}"
            _run(pkg, d, poison)
            dirs[(pkg, poison)] = str(d)
    return dirs


@pytest.mark.parametrize("writer", PKGS)
@pytest.mark.parametrize("poison", [False, True], ids=["healthy", "dead"])
def test_run_doctor_json_and_codes_match_jax(doctor_dirs, writer, poison):
    d = doctor_dirs[(writer, poison)]
    got = {which: _cli(which, "run_doctor", [d, "--json"])
           for which in ("jax", "port")}
    assert got["port"][0] == got["jax"][0] == 0
    doc = json.loads(got["port"][1])
    assert doc == json.loads(got["jax"][1])
    assert doc["verdict"] == ("dead" if poison else "healthy")
    for flags in (["--check"], ["--check", "--strict"]):
        codes = {which: _cli(which, "run_doctor", [d, *flags])[0]
                 for which in ("jax", "port")}
        assert codes["port"] == codes["jax"], (flags, codes)
    assert codes["port"] == (3 if poison else 0)


def test_run_doctor_refuses_a_corrupted_total(doctor_dirs, tmp_path):
    d = str(tmp_path / "bad")
    shutil.copytree(doctor_dirs[("flexflow_tpu_torch", False)], d)
    path = os.path.join(d, "strategy_report.json")
    rep = json.load(open(path))
    rep["total_predicted_s"] = rep["total_predicted_s"] * 2 + 1.0
    json.dump(rep, open(path, "w"))
    for which in ("jax", "port"):
        assert _cli(which, "run_doctor", [d, "--check"])[0] == 1, which
        assert _cli(which, "run_doctor",
                    [str(tmp_path / "none"), "--json"])[0] == 2, which


# -------------------------------------------------------- check_warmstart

def warm_rank(rank, root):
    """A cold then a warm compile of the MLP under the search on a mesh of
    the two ranks, one --warmstart-dir, a telemetry dir each; one fit of
    each."""
    from flexflow_tpu_torch import (
        ActiMode,
        FFConfig,
        FFModel,
        LossType,
        SGDOptimizer,
    )
    from flexflow_tpu_torch.telemetry import deactivate

    rs = np.random.RandomState(0)
    x = rs.randn(64, 64).astype(np.float32)
    y = rs.randint(0, 16, (64, 1)).astype(np.int32)
    for tag in ("cold", "warm"):
        sys.argv = ["t", "--device", "cpu", "--mesh", "2,1,1,1",
                    "--budget", "6", "--enable-parameter-parallel",
                    "--warmstart-dir", os.path.join(root, "ws"),
                    "--telemetry-dir", os.path.join(root, f"{tag}_{rank}")]
        ff = FFModel(FFConfig())
        t = ff.create_tensor((32, 64), name="x")
        t = ff.dense(t, 128, ActiMode.AC_MODE_RELU, name="dense1")
        ff.softmax(ff.dense(t, 16, name="dense2"), name="sm")
        ff.compile(optimizer=SGDOptimizer(lr=0.01),
                   loss_type=LossType.LOSS_SPARSE_CATEGORICAL_CROSSENTROPY)
        ff.fit(x, y, epochs=1, batch_size=32, verbose=False)
        deactivate()
    return True


def test_check_warmstart_passes_cold_warm_and_fails_swapped(tmp_path):
    from flexflow_tpu_torch.distributed import spawn

    root = str(tmp_path)
    assert spawn(warm_rank, 2, root, timeout=180) == [True, True]
    cold, warm = (os.path.join(root, f"{t}_0", "metrics.jsonl")
                  for t in ("cold", "warm"))
    for which in ("jax", "port"):
        rc, out = _cli(which, "check_warmstart", [cold, warm])
        assert rc == 0 and "check_warmstart: OK" in out, which
        assert _cli(which, "check_warmstart", [warm, cold])[0] == 1, which
        assert _cli(which, "check_warmstart", [cold])[0] == 1, which
