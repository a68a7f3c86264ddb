"""`bench_torch.py`'s legs against `bench.py`'s, on the CPU at bench.py's
CPU-mode sizes, and the two measurement twins.

- One rank: `bench.py` runs whole on one virtual JAX device (a
  subprocess), `bench_torch.main(["--device", "cpu", "--legs", "all"])`
  in this process. Every line bench.py prints, the port prints under
  the same metric with the same keys and unit, and the payload's leg
  fields carry the same keys, nested; the rules leg's fingerprint and
  rule count are the JAX package's. The seq4096 leg (bench.py runs it on
  a TPU only) is held to the keys of `_attention_ablation_legs` on one
  device. Keys naming the serial collective schedule ("serial"), which
  the port does not have, are left out of the key sets; the port prints
  each of them null or as a skip reason.
- Four ranks: `chip_smoke.mesh_bench_check` (the torchrun run's bench
  leg) at a tiny LM on 4 gloo ranks; its grad-sync, param-sharding,
  migration and elastic legs against bench.py's on 4 of the test
  process's virtual devices: the migration plan's transfers and bytes on
  the wire equal, its predicted seconds within 1e-6 s (both rounded to
  1e-6), the elastic decision equal, the other legs' keys equal.
- Four ranks, the script whole: `test_torch_bench_torchrun.py`.
- A leg that raises ends the run with a nonzero exit.
- `bench_ablate_torch.py` and `bench_checkpoint_torch.py` run with
  `--device cpu` and print the JAX scripts' keys.
"""

import contextlib
import io
import json
import os
import subprocess
import sys

import pytest
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import bench  # noqa: E402
import bench_torch  # noqa: E402

TINY = dict(vocab_size=64, hidden_size=32, num_heads=2, num_layers=1,
            sequence_length=16, attention_impl="xla")
FOUR_RANK_LEGS = ("grad_sync", "param_sharding", "migration", "elastic")

# bench.py on one virtual device, then `_attention_ablation_legs` of a
# tiny LM (its key set on one device)
JAX_RUN = """
import json, sys
sys.argv = ["bench.py"]
import jax
jax.config.update("jax_platforms", "cpu")
sys.path.insert(0, {repo!r})
import bench
bench.main()
from flexflow_tpu.models import TransformerLMConfig
lcfg = TransformerLMConfig(**{tiny!r})
print("ABLATION " + json.dumps(
    bench._attention_ablation_legs(lcfg, 1, 1, 1, False, 1.0)))
"""


def lines_of(text: str) -> list:
    return [json.loads(t) for t in text.splitlines() if t.startswith("{")]


def by_metric(lines: list) -> dict:
    return {d["metric"]: d for d in lines if "metric" in d}


def plain_keys(d: dict) -> set:
    """A leg's keys, the serial-schedule ablations left out."""
    return {k for k in d if "serial" not in k}


def assert_same_keys(port: dict, want: dict, where: str):
    """Equal key sets (serial keys aside), nested dicts alike; every
    serial key of the port null or a skip reason."""
    assert plain_keys(port) == plain_keys(want), (where, sorted(port),
                                                  sorted(want))
    for k, v in port.items():
        if "serial" in k and isinstance(v, dict):
            # a serial leg of bench.py's, its numbers null, with a reason
            assert set(v) == set(want[k]) | {"skipped"}, (where, k, v)
            assert all(x is None for kk, x in v.items()
                       if kk != "skipped"), (where, k, v)
        elif "serial" in k:
            assert v is None or isinstance(v, str), (where, k, v)
        elif isinstance(v, dict) and isinstance(want.get(k), dict):
            assert_same_keys(v, want[k], f"{where}.{k}")


@pytest.fixture(scope="module")
def one_rank():
    env = dict(os.environ, PYTHONPATH=REPO, XLA_FLAGS="--xla_force_host_platform_device_count=1")
    p = subprocess.run(
        [sys.executable, "-c", JAX_RUN.format(repo=REPO, tiny=TINY)],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=600)
    assert p.returncode == 0, p.stderr[-4000:]
    jax_lines = lines_of(p.stdout)
    ablation = json.loads(next(t for t in p.stdout.splitlines()
                               if t.startswith("ABLATION "))[9:])
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert bench_torch.main(["--device", "cpu", "--legs", "all"]) == 0
    return {"jax": jax_lines, "ablation": ablation,
            "port": lines_of(buf.getvalue())}


def test_one_rank_lines_carry_bench_py_keys_and_units(one_rank):
    jax, port = by_metric(one_rank["jax"]), by_metric(one_rank["port"])
    primary = "transformer_lm_tokens_per_sec_per_chip"
    # bench.py's last line is its payload; the port's is the primary line
    # alone, its payload the line before it
    assert one_rank["port"][-1]["metric"] == primary
    assert set(one_rank["port"][-1]) == {"metric", "value", "unit",
                                         "vs_baseline"}
    assert one_rank["port"][-2]["metric"] == "transformer_lm_bench_payload"
    for metric, want in jax.items():
        if metric == primary:
            continue
        assert metric in port, metric
        assert_same_keys(port[metric], want, metric)
        assert port[metric].get("unit") == want.get("unit"), metric


def test_one_rank_payload_fields_carry_bench_py_keys(one_rank):
    want = one_rank["jax"][-1]
    got = one_rank["port"][-2]
    legs = set(want) - {"metric", "value", "unit", "vs_baseline"}
    assert legs - {"seq4096"} <= set(got), sorted(legs - set(got))
    for leg in legs:
        if isinstance(want[leg], dict):
            assert_same_keys(got[leg], want[leg], leg)
    # the leg bench.py runs on a TPU only, held to its ablation's keys
    seq = got["seq4096"]
    assert set(seq) == {"metric", "value", "unit", "vs_baseline",
                        "ablation"}
    assert seq["metric"] == "transformer_lm_tokens_per_sec_per_chip_seq4096"
    assert_same_keys(seq["ablation"], one_rank["ablation"], "seq4096")
    assert seq["ablation"]["flash_transposed_tokens_per_sec"] > 0


def test_rules_leg_pins_the_jax_registry(one_rank):
    want = one_rank["jax"][-1]["rules"]
    got = one_rank["port"][-2]["rules"]
    assert got["fingerprint"] == want["fingerprint"]
    assert got["rules"] == want["rules"] and got["rules"] > 0
    assert got["scope"] == want["scope"] == "static_registry"


def test_one_rank_skips_name_the_world(one_rank):
    got = one_rank["port"][-2]
    for leg in ("grad_sync", "param_sharding", "migration", "elastic"):
        assert got[leg]["skipped"].startswith("1 rank(s) — "), got[leg]
    assert got["serving"]["disagg"]["skipped"].startswith("1 rank(s) — ")
    # the legs that run on one rank ran
    assert got["fit_loop"]["eager_tokens_per_sec"] > 0
    assert got["serving"]["paged"]["prefix_hit_rate"] > 0
    assert got["warmstart"]["cold_time_to_first_step_s"] > 0


def four_rank_legs(rank):
    """`chip_smoke.py`'s torchrun bench leg, rehearsed at the tiny LM."""
    import chip_smoke
    from flexflow_tpu_torch.models import TransformerLMConfig

    return chip_smoke.mesh_bench_check(
        "cpu", lm=TransformerLMConfig(**TINY), steps=1)


@pytest.fixture(scope="module")
def four_ranks():
    from flexflow_tpu.models import TransformerLMConfig
    from flexflow_tpu_torch.distributed import spawn

    ranks = spawn(four_rank_legs, 4, timeout=400)
    cfg = TransformerLMConfig(**TINY)
    saved = list(sys.argv)
    try:
        jax = {
            "grad_sync": bench._grad_sync_legs(cfg, 4, 1, 1, False),
            "param_sharding": bench._param_sharding_legs(cfg, 4, 1, 1,
                                                         False),
            "migration": bench._migration_legs(cfg, False),
            "elastic": bench._elastic_legs(cfg, False),
        }
    finally:
        sys.argv = saved
    return {"ranks": ranks, "jax": jax}


def test_four_rank_migration_plan_and_elastic_decision_match_jax(
        four_ranks):
    port = four_ranks["ranks"][0]
    jax = four_ranks["jax"]
    mig, jmig = port["migration"], jax["migration"]
    assert mig["transfers"] == jmig["transfers"] > 0
    assert mig["bytes_on_wire"] == jmig["bytes_on_wire"] > 0
    assert abs(mig["predicted_s"] - jmig["predicted_s"]) <= 1e-6, (mig, jmig)
    assert mig["errors"] == jmig["errors"] == 0 and mig["measured_s"] > 0
    assert port["elastic"]["decision"] == jax["elastic"]["decision"]
    for leg in FOUR_RANK_LEGS:
        assert_same_keys(port[leg], jax[leg], leg)
    # rank 0 printed each leg's line; the other ranks printed none
    assert [d["metric"] for d in port["lines"]] == [
        "transformer_lm_tokens_per_sec_per_chip_seq4096",
        "grad_sync_ablation", "param_sharding_ablation",
        "migration_seconds", "elastic_replan"]
    assert all(r["lines"] == [] for r in four_ranks["ranks"][1:])
    assert all(r["failures"] == [] for r in four_ranks["ranks"]), [
        r["failures"] for r in four_ranks["ranks"]]


def test_four_rank_sharding_legs_measure_each_mode(four_ranks):
    port = four_ranks["ranks"][0]
    gs, ps = port["grad_sync"], port["param_sharding"]
    assert gs["update_shards"] == 4 and "skipped" not in gs
    assert gs["replicated_tokens_per_sec"] > 0
    assert gs["sharded_overlap_tokens_per_sec"] > 0
    assert gs["rs_microbench"]["overlap_s"] > 0
    assert ps["stage3"]["update_stage"] == 3
    assert ps["replicated"]["update_stage"] == 0
    # stage 3 holds a quarter of the parameters at rest on each rank
    assert ps["param_bytes_ratio"] == pytest.approx(4.0, rel=0.05)
    assert ps["ag_microbench"]["overlap_s"] > 0
    # the ring over `seq` ran on the 4 ranks
    assert port["seq4096"]["ablation"]["ring_seq_shards"] == 4
    assert port["seq4096"]["ablation"]["ring_overlap_tokens_per_sec"] > 0
    # every rank computed the same plan sizes
    for r in four_ranks["ranks"][1:]:
        assert r["migration"]["transfers"] == port["migration"]["transfers"]


def test_a_leg_that_raises_fails_the_run():
    code = (f"import sys; sys.path.insert(0, {REPO!r})\n"
            "import bench_torch\n"
            "def boom(b):\n"
            "    raise RuntimeError('a planted fault in the leg')\n"
            "bench_torch.LEG_FNS['warmstart'] = boom\n"
            "sys.exit(bench_torch.main(['--device', 'cpu', '--legs', "
            "'rules,warmstart']))\n")
    p = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                       env=dict(os.environ),
                       capture_output=True, text=True, timeout=300)
    assert p.returncode != 0
    assert "a planted fault in the leg" in p.stderr
    # the lines before the fault stay printed; no payload, no skip
    assert [d["metric"] for d in lines_of(p.stdout)] == [
        "rules_verify_wall_s"]


def test_legs_argument():
    assert bench_torch.parse_legs(None, "cpu") == ["primary"]
    assert bench_torch.parse_legs(None, "cuda") == list(bench_torch.LEGS)
    assert bench_torch.parse_legs("rules, seq4096", "cpu") == [
        "seq4096", "rules"]
    with pytest.raises(ValueError, match="nope"):
        bench_torch.parse_legs("primary,nope", "cpu")
    with contextlib.redirect_stderr(io.StringIO()), \
            pytest.raises(SystemExit) as e:
        bench_torch.main(["--device", "cpu", "--legs", "nope"])
    assert e.value.code == 2


ABLATE_KEYS = {"attn", "batch", "no_metrics", "no_opt", "fwd_only",
               "ms_per_step", "tokens_per_sec"}  # scripts/bench_ablate.py:96


def test_bench_ablate_twin_runs_each_switch_with_the_jax_keys():
    import bench_ablate_torch

    full = bench_ablate_torch.run("cpu", env={"ABL_BATCH": "2"})
    fwd = bench_ablate_torch.run("cpu", env={"ABL_BATCH": "2",
                                             "ABL_FWD_ONLY": "1"})
    rest = bench_ablate_torch.run("cpu", env={
        "ABL_BATCH": "2", "ABL_ATTN": "xla", "ABL_NO_OPT": "1",
        "ABL_NO_METRICS": "1"})
    for r in (full, fwd, rest):
        assert set(r) == ABLATE_KEYS and r["ms_per_step"] > 0
    assert fwd["fwd_only"] and not full["fwd_only"]
    assert rest["no_opt"] and rest["no_metrics"] and rest["attn"] == "xla"
    p = subprocess.run(
        [sys.executable, os.path.join(REPO, "bench_ablate_torch.py"),
         "--device", "cpu"], cwd=REPO, capture_output=True, text=True,
        env=dict(os.environ, PYTHONPATH=REPO, ABL_BATCH="2",
                 ABL_FWD_ONLY="1"), timeout=300)
    assert p.returncode == 0, p.stderr[-3000:]
    last = json.loads(p.stdout.strip().splitlines()[-1])
    assert set(last) == ABLATE_KEYS and last["fwd_only"] is True


def test_bench_checkpoint_twin_prints_the_jax_lines():
    p = subprocess.run(
        [sys.executable, os.path.join(REPO, "bench_checkpoint_torch.py"),
         "--device", "cpu"], cwd=REPO, capture_output=True, text=True,
        env=dict(os.environ, PYTHONPATH=REPO), timeout=300)
    assert p.returncode == 0, p.stderr[-3000:]
    lines = lines_of(p.stdout)
    # scripts/bench_checkpoint.py:104-120: a line a cadence, the
    # headline (cadence 32) last with the blocking cost
    row = {"metric", "checkpoint_every", "overhead_frac", "baseline_s",
           "with_checkpoint_s", "note"}
    assert [set(d) for d in lines] == [
        row, row | {"blocking_cost_ms_per_save", "within_10pct"}]
    assert [d["checkpoint_every"] for d in lines] == [8, 32]
    assert all(d["metric"] == "async_checkpoint_overhead_frac"
               and d["baseline_s"] > 0 and d["with_checkpoint_s"] > 0
               for d in lines)
    assert lines[-1]["blocking_cost_ms_per_save"] > 0
