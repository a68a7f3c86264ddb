"""A JAX-style script under `torchrun`, with only its import changed (ROADMAP
C8).

`examples/unity_vs_dp.py`, its package swapped and its JAX platform pin
left out (`chip_smoke.port_example_source`), runs under `python -m
torch.distributed.run --nproc-per-node 2` with `--device cpu` and starts
no process group of its own: the port's `FFConfig` joins torchrun's
world, so both ranks form one world of 2 (gloo), with one mesh and one
plan, as the JAX example on 2 virtual devices sees 2 devices and
searches one plan. A thin runner around the script records, per rank,
the world the script left behind and the mesh of each compile; it
starts nothing itself.
"""

import json
import os
import subprocess
import sys
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FLAGS = ("-b", "8", "--hidden", "256")

# runs the script as __main__ (its temporary files in a directory the
# ranks share), then records the world it left behind, also when it fails
RUNNER = """
import json, os, runpy, sys, tempfile
script, workdir = sys.argv[1], sys.argv[2]
rank = os.environ["RANK"]
sys.argv = [script] + sys.argv[3:]
tempfile.tempdir = workdir
os.environ["UNITY_VS_DP_ARTIFACT"] = os.path.join(workdir,
                                                  f"artifact{rank}.json")
from flexflow_tpu_torch.model import FFModel
meshes, compile = [], FFModel.compile


def recording(self, *a, **kw):
    out = compile(self, *a, **kw)
    meshes.append({k: int(v) for k, v in self.mesh.shape.items()})
    return out


FFModel.compile = recording
try:
    runpy.run_path(script, run_name="__main__")
finally:
    import torch.distributed as dist
    up = dist.is_initialized()
    rec = {"rank": int(rank), "group": up, "meshes": meshes,
           "world": dist.get_world_size() if up else 1,
           "backend": dist.get_backend() if up else None}
    with open(os.path.join(workdir, f"world{rank}.json"), "w") as f:
        json.dump(rec, f)
"""


def test_script_under_torchrun_joins_one_world_as_jax_sees_two_devices(
        tmp_path):
    sys.path.insert(0, REPO)
    import chip_smoke
    from flexflow_tpu_torch.distributed import free_port

    port_dir, jax_dir = tmp_path / "port", tmp_path / "jax"
    port_dir.mkdir()
    jax_dir.mkdir()
    script = port_dir / "unity_vs_dp.py"
    script.write_text(chip_smoke.port_example_source("unity_vs_dp.py"))
    runner = port_dir / "runner.py"
    runner.write_text(RUNNER)
    env = dict(os.environ, PYTHONPATH=REPO)
    p = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--nnodes", "1",
         "--nproc-per-node", "2", "--master-addr", "localhost",
         "--master-port", str(free_port()), str(runner), str(script),
         str(port_dir), "--device", "cpu", *FLAGS],
        cwd=str(port_dir), env=env, capture_output=True, text=True,
        timeout=300)
    worlds = [json.load(open(port_dir / f"world{r}.json")) for r in (0, 1)]
    # the parent's port: two worlds of one rank each, no group
    assert [(w["group"], w["world"]) for w in worlds] == [(True, 2)] * 2, (
        worlds, p.stderr[-3000:])
    assert {w["backend"] for w in worlds} == {"gloo"}
    # one mesh: every compile of every rank (dp, unity, the replay) lays
    # the 2 ranks on `data`, as the JAX example's default mesh of 2
    # devices
    for w in worlds:
        assert w["meshes"] == [{"data": 2, "model": 1, "pipe": 1,
                                "seq": 1}] * 3, w
    assert p.returncode == 0, p.stdout[-2000:] + p.stderr[-4000:]

    jenv = dict(os.environ, PYTHONPATH=REPO, TMPDIR=str(jax_dir),
                UNITY_VS_DP_ARTIFACT=str(jax_dir / "artifact.json"),
                XLA_FLAGS="--xla_force_host_platform_device_count=2")
    j = subprocess.run([sys.executable,
                        os.path.join(REPO, "examples", "unity_vs_dp.py"),
                        *FLAGS], cwd=str(jax_dir), env=jenv,
                       capture_output=True, text=True, timeout=300)
    assert j.returncode == 0, j.stdout[-2000:] + j.stderr[-4000:]
    want = json.load(open(jax_dir / "unity_plan.json"))
    # one plan: rank 0 exported it, the third run of every rank imported
    # it, and it is the JAX example's on 2 devices
    assert json.load(open(port_dir / "unity_plan.json")) == want
    arts = [json.load(open(port_dir / f"artifact{r}.json")) for r in (0, 1)]
    for a in arts:
        assert a["dp_samples_per_s"] > 0 and a["unity_samples_per_s"] > 0
        assert a["unity_replay_samples_per_s"] > 0
