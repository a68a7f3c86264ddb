"""The port's model-level CLIs — `cost_model_fidelity_torch.py` and
`run_ae_torch.py` — against the JAX package's
`scripts/cost_model_fidelity.py` and `scripts/run_ae.py`, on the CPU.

- fidelity: every config of `cpu_configs()` built in both packages; the
  raw predicted step (the composed makespan over the CPU's machine entry,
  which both packages price alike) equal to the JAX script's to 1e-6
  relative; the twin's run on two configs writes a report with the JAX
  script's keys, finite numbers and nothing beside the path it was given;
  an unknown config exits 2; the calibration measures the fused MoE's
  Experts op (its assignment drawn as expert indices);
- run_ae: `--models nope` exits as the JAX script does (SystemExit naming
  the model set); mlp and dlrm in modes unity and dp on 4 gloo ranks
  against the JAX script on 4 virtual devices (a subprocess): the same
  `AE_RESULT["mesh"]` per run, and the MLP's 90% accuracy gate met in
  both.
"""

import contextlib
import importlib.util
import io
import json
import math
import os
import re
import subprocess
import sys

import pytest
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _load(path: str, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def fidelity():
    port = _load(os.path.join(REPO, "cost_model_fidelity_torch.py"),
                 "port_fidelity_under_test")
    jax = _load(os.path.join(REPO, "scripts", "cost_model_fidelity.py"),
                "jax_fidelity_under_test")
    return {"port": port, "jax": jax}


def _compiled(pkg, spec):
    mod = __import__(pkg)
    ff, _, _ = (spec["make"]("cpu") if pkg == "flexflow_tpu_torch"
                else spec["make"]())
    ff.compile(optimizer=mod.SGDOptimizer(lr=0.01),
               loss_type=mod.LossType.LOSS_SPARSE_CATEGORICAL_CROSSENTROPY)
    return ff


# the JAX script's raw predictions on one device (its CPU battery's
# single-chip configs), in a process of its own: this session's JAX has 8
_JAX_PREDICT = """
import json, sys
import jax
jax.config.update("jax_platforms", "cpu")
sys.path.insert(0, {repo!r})
import importlib.util
spec = importlib.util.spec_from_file_location(
    "fid", {repo!r} + "/scripts/cost_model_fidelity.py")
fid = importlib.util.module_from_spec(spec)
spec.loader.exec_module(fid)
from flexflow_tpu import LossType, SGDOptimizer
out = {{}}
for c in fid.cpu_configs():
    ff, _, _ = c["make"]()
    ff.compile(optimizer=SGDOptimizer(lr=0.01),
               loss_type=LossType.LOSS_SPARSE_CATEGORICAL_CROSSENTROPY)
    out[c["name"]] = fid.predict_step_time(ff)
print(json.dumps(out))
"""


def test_fidelity_raw_predictions_match_jax(fidelity):
    port, jax = fidelity["port"], fidelity["jax"]
    assert ([c["name"] for c in port.cpu_configs()]
            == [c["name"] for c in jax.cpu_configs()])
    assert ([c["name"] for c in port.card_configs()]
            == [c["name"] for c in jax.tpu_configs()])
    p = subprocess.run(
        [sys.executable, "-c", _JAX_PREDICT.format(repo=REPO)],
        capture_output=True, text=True, timeout=300,
        env=dict(os.environ,
                 XLA_FLAGS="--xla_force_host_platform_device_count=1"))
    assert p.returncode == 0, p.stderr[-3000:]
    want = json.loads(p.stdout.strip().splitlines()[-1])
    got = {c["name"]: port.predict_step_time(
        _compiled("flexflow_tpu_torch", c)) for c in port.cpu_configs()}
    assert sorted(got) == sorted(want)
    for name, v in got.items():
        assert v == pytest.approx(want[name], rel=1e-6), name
    assert port._spearman([1, 2, 3], [2, 4, 9]) == jax._spearman(
        [1, 2, 3], [2, 4, 9])


def test_fidelity_report_keys_and_files(fidelity, tmp_path):
    port = fidelity["port"]
    out = str(tmp_path / "fidelity.json")
    with contextlib.redirect_stdout(io.StringIO()):
        rc = port.main([out, "--device", "cpu", "--configs",
                        "lm_h64_s32_b4,mlp_b16_h256"])
    assert rc == 0
    assert os.listdir(tmp_path) == ["fidelity.json"]
    rep = json.load(open(out))
    assert sorted(rep) == sorted([
        "device", "n_configs", "configs", "spearman", "spearman_calibrated",
        "mean_abs_rel_err", "mean_abs_rel_err_calibrated"])
    assert rep["n_configs"] == 2 and rep["device"] == "cpu"
    for row in rep["configs"]:
        assert sorted(row) == sorted([
            "name", "measured_ms", "predicted_ms",
            "predicted_calibrated_ms", "rel_err", "rel_err_calibrated"])
        assert all(math.isfinite(v) and v != 0 for k, v in row.items()
                   if k.endswith("_ms"))
    with contextlib.redirect_stdout(io.StringIO()), \
            contextlib.redirect_stderr(io.StringIO()):
        assert port.main(["--device", "cpu", "--configs", "nope"]) == 2


def test_run_ae_unknown_model_exits_as_jax():
    port = _load(os.path.join(REPO, "run_ae_torch.py"), "port_run_ae")
    with pytest.raises(SystemExit) as got, \
            contextlib.redirect_stdout(io.StringIO()):
        port.main(["--device", "cpu", "--models", "nope"])
    jax = subprocess.run(
        [sys.executable, os.path.join(REPO, "scripts", "run_ae.py"),
         "--models", "nope"], capture_output=True, text=True, timeout=120,
        env=dict(os.environ, PYTHONPATH=REPO))
    assert jax.returncode == 1
    assert str(got.value.code) in jax.stderr


def ae_rank(rank):
    import run_ae_torch

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        run_ae_torch.main(["--device", "cpu", "--models", "mlp,dlrm"])
    return buf.getvalue()


def _ae_results(text: str) -> list:
    return [json.loads(m) for m in re.findall(r"^AE_RESULT (.*)$", text,
                                              re.M)]


def test_run_ae_meshes_and_gate_match_jax_on_four_ranks():
    from flexflow_tpu_torch.distributed import spawn

    sys.path.insert(0, REPO)
    outs = spawn(ae_rank, 4, timeout=240)
    port = _ae_results(outs[0])
    assert all(_ae_results(o) == [] for o in outs[1:])  # rank 0 prints
    env = dict(os.environ, PYTHONPATH=REPO,
               XLA_FLAGS="--xla_force_host_platform_device_count=4")
    p = subprocess.run(
        [sys.executable, os.path.join(REPO, "scripts", "run_ae.py"),
         "--models", "mlp,dlrm"], capture_output=True, text=True,
        timeout=300, env=env)
    assert p.returncode == 0, p.stderr[-3000:]
    jax = _ae_results(p.stdout)
    key = [(r["model"], r["mode"], r["mesh"]) for r in jax]
    assert [(r["model"], r["mode"], r["mesh"]) for r in port] == key
    assert len(key) == 4
    for res in (port, jax):
        mlp = [r for r in res if r["model"] == "mlp"]
        assert all(r["accuracy"] >= r["gate"] == 0.9 for r in mlp)
        assert all(r["samples_per_sec"] > 0 for r in res)


def test_calibration_measures_the_fused_experts_op(fidelity):
    """calibrate_graph over the fused MoE (fidelity's
    `moe_flat_b256_fused`) measures its Experts op: the harness draws the
    expert assignment as indices in [0, n), and the operand the output
    does not depend on differentiably takes no gradient."""
    from flexflow_tpu_torch.fftype import OperatorType as OT
    from flexflow_tpu_torch.search.cost_model import (
        CostModel,
        OpHarness,
        _params_key,
    )
    from flexflow_tpu_torch.search.machine_model import (
        machine_model_for_mesh,
    )

    port = fidelity["port"]
    spec = next(c for c in port.card_configs()
                if c["name"] == "moe_flat_b256_fused")
    ff = _compiled("flexflow_tpu_torch", spec)
    cm = CostModel(machine_model_for_mesh(ff.mesh))
    cm.harness = OpHarness.of(ff.config, ff.device)
    assert cm.calibrate_graph(ff.graph, top_k=1) == 1
    node = next(n for n in ff.graph.topo_order()
                if n.op_type == OT.OP_EXPERTS)
    fwd, bwd = cm._calibration[_params_key(node)]
    assert fwd > 0 and bwd > 0
