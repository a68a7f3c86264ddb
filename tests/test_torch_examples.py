"""The north star's three examples under the port (ROADMAP A12's
acceptance): `examples/mnist_mlp.py`, `examples/keras_mnist_mlp.py` and
`examples/transformer.py`, each copied into a temporary directory with
`flexflow_tpu` replaced by `flexflow_tpu_torch` and nothing else changed,
run as a script with `--device cpu` at small flags.

The two MLPs keep their own accuracy gate (>= 0.9, an assert in the
script) and print their final accuracy, held within 0.05 of the JAX
package's run of the unchanged example at the same flags (the weights are
drawn by different generators, so the runs are not equal step for step).
The transformer exits 0 and prints its THROUGHPUT line.

`examples/unity_vs_dp.py` pins the JAX package's platform with an import
of jax (three lines the port's copy leaves out, as
`chip_smoke.port_example_source` says; the port takes its device from
`--device`). It runs in this process on 4 gloo ranks (the example starts
no group itself), at `-b 16 --hidden 1024 --mesh 2,2,1,1`: its searched
plan, exported and replayed by import, equals the JAX example's on 4
virtual devices (a subprocess) exactly, and every rank holds the plan.
"""

import json
import os
import re
import runpy
import subprocess
import sys

import pytest
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ACC = re.compile(r"final accuracy: ([0-9.]+)")


def _port_copy(tmp_path, name):
    src = open(os.path.join(REPO, "examples", name)).read()
    dst = tmp_path / name
    dst.write_text(src.replace("flexflow_tpu", "flexflow_tpu_torch"))
    return str(dst)


def _run_port(tmp_path, name, *flags):
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    p = subprocess.run(
        [sys.executable, _port_copy(tmp_path, name), "--device", "cpu",
         *flags], cwd=REPO, env=env, capture_output=True, text=True,
        timeout=300)
    assert p.returncode == 0, p.stdout[-2000:] + p.stderr[-4000:]
    return p.stdout


def _run_jax(name, capsys, *flags):
    sys.argv = [name, *flags]
    runpy.run_path(os.path.join(REPO, "examples", name),
                   run_name="__main__")
    return capsys.readouterr().out


@pytest.mark.parametrize("name,flags", [
    ("mnist_mlp.py", ("-b", "64", "-e", "2")),
    ("keras_mnist_mlp.py", ("-b", "64")),
])
def test_mlp_example_runs_under_the_port_as_under_jax(tmp_path, capsys,
                                                      name, flags):
    port = float(ACC.search(_run_port(tmp_path, name, *flags)).group(1))
    want = float(ACC.search(_run_jax(name, capsys, *flags)).group(1))
    assert port >= 0.9 and want >= 0.9
    assert abs(port - want) <= 0.05, (port, want)


def test_transformer_example_runs_under_the_port(tmp_path):
    out = _run_port(tmp_path, "transformer.py", "-b", "2", "-e", "1",
                    "--num-layers", "2", "--hidden-size", "64",
                    "--num-heads", "4", "--sequence-length", "16")
    m = re.search(r"ELAPSED TIME = ([0-9.]+)s, THROUGHPUT = ([0-9.]+) "
                  r"samples/s", out)
    assert m and float(m.group(2)) > 0, out


def unity_rank(rank, workdir, flags):
    import chip_smoke

    return chip_smoke.run_port_example("unity_vs_dp.py", list(flags),
                                       workdir)


def test_unity_vs_dp_searches_the_jax_plan_on_four_ranks(tmp_path):
    from flexflow_tpu_torch.distributed import spawn

    flags = ("-b", "16", "--hidden", "1024", "--mesh", "2,2,1,1")
    sys.path.insert(0, REPO)
    port_dir, jax_dir = tmp_path / "port", tmp_path / "jax"
    port_dir.mkdir()
    jax_dir.mkdir()
    ranks = spawn(unity_rank, 4, str(port_dir), ("--device", "cpu", *flags),
                  timeout=240)
    env = dict(os.environ, PYTHONPATH=REPO, TMPDIR=str(jax_dir),
               UNITY_VS_DP_ARTIFACT=str(jax_dir / "artifact.json"),
               XLA_FLAGS="--xla_force_host_platform_device_count=4")
    p = subprocess.run([sys.executable,
                        os.path.join(REPO, "examples", "unity_vs_dp.py"),
                        *flags], cwd=str(jax_dir), env=env,
                       capture_output=True, text=True, timeout=300)
    assert p.returncode == 0, p.stdout[-2000:] + p.stderr[-4000:]
    want = json.load(open(jax_dir / "unity_plan.json"))
    assert want["nodes"], want  # the search chose a plan beyond dp
    for r in ranks:
        assert r["plan"] == want
        assert r["dp_samples_per_s"] > 0 and r["unity_samples_per_s"] > 0
        assert r["unity_replay_samples_per_s"] > 0
