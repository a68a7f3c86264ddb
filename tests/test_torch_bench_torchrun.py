"""`bench_torch.py` whole on the torchrun world, rehearsed on the CPU:
`bench_torch.main(["--device", "cpu", "--legs", "all"])` on 4 gloo ranks
at a tiny LM (the fit and serving legs at bench.py's CPU-mode LM), as
`torchrun --nproc-per-node 4 bench_torch.py` runs it. Every leg runs on
the world and rank 0 alone prints, the primary line last. The
disaggregated serving leg (its three completion equalities hold, or it
raises), the speculative leg and the warm-start leg's search branch are
held to bench.py's `_serving_legs` and `_warmstart_legs` on the test
process's 8 virtual devices: the same keys, nested (the serial-schedule
keys aside, as in `test_torch_bench_legs.py`).
"""

import contextlib
import io
import os
import sys
from unittest import mock

import pytest
from test_torch_bench_legs import TINY, assert_same_keys, lines_of
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import bench  # noqa: E402
import bench_torch  # noqa: E402


def four_rank_script(rank):
    """`bench_torch.py --device cpu --legs all` on this rank of the
    started world, its LM the tiny one."""
    from flexflow_tpu_torch.models import TransformerLMConfig

    buf = io.StringIO()
    with mock.patch.object(bench_torch, "lm_of",
                           lambda tier, layers=None: TransformerLMConfig(
                               **TINY)), contextlib.redirect_stdout(buf):
        rc = bench_torch.main(["--device", "cpu", "--legs", "all"])
    return {"rc": rc, "lines": lines_of(buf.getvalue())}


@pytest.fixture(scope="module")
def four_rank_script_run():
    from flexflow_tpu.models import TransformerLMConfig
    from flexflow_tpu_torch.distributed import spawn

    ranks = spawn(four_rank_script, 4, timeout=400)
    saved = list(sys.argv)
    try:
        jax = {"serving": bench._serving_legs(TransformerLMConfig(**TINY),
                                              False),
               "warmstart": bench._warmstart_legs()}
    finally:
        sys.argv = saved
    return {"ranks": ranks, "jax": jax}


def test_four_rank_script_runs_every_leg_on_the_world(four_rank_script_run):
    ranks = four_rank_script_run["ranks"]
    assert [r["rc"] for r in ranks] == [0] * 4
    assert all(r["lines"] == [] for r in ranks[1:])
    lines = ranks[0]["lines"]
    metrics = [d.get("metric") for d in lines]
    # the primary leg's detail line, each leg's lines, the payload, and
    # the primary line last
    assert "metric" not in lines[0] and lines[0]["tier"] == "lm-smoke"
    assert metrics[-2:] == ["transformer_lm_bench_payload",
                            "transformer_lm_tokens_per_sec_per_chip"]
    for metric in ("transformer_lm_tokens_per_sec_per_chip_seq4096",
                   "transformer_lm_fit_tokens_per_sec_eager",
                   "transformer_lm_fit_tokens_per_sec_pipelined",
                   "grad_sync_ablation", "param_sharding_ablation",
                   "serving_disagg_ttft_p95_s",
                   "serving_disagg_prefix_hit_rate_cross_time",
                   "serving_spec_tbt_p95_s", "migration_seconds",
                   "elastic_replan", "rules_verify_wall_s",
                   "warmstart_time_to_first_step_s"):
        assert metric in metrics, metric
    payload = lines[-2]
    for leg in ("seq4096", "grad_sync", "param_sharding", "migration",
                "elastic"):
        assert "skipped" not in payload[leg], payload[leg]
    assert payload["seq4096"]["ablation"]["ring_seq_shards"] == 4
    assert payload["elastic"]["decision"] is not None
    assert lines[-1]["value"] > 0


def test_four_rank_script_serving_and_warmstart_match_jax_keys(
        four_rank_script_run):
    payload = four_rank_script_run["ranks"][0]["lines"][-2]
    jax = four_rank_script_run["jax"]
    dg, sg = payload["serving"]["disagg"], payload["serving"]["spec"]
    assert "skipped" not in jax["serving"]["disagg"], jax["serving"]
    assert "skipped" not in jax["serving"]["spec"], jax["serving"]
    # the world split in halves; the handoffs went over the ranks
    assert (dg["prefill_chips"], dg["decode_chips"]) == (2, 2)
    assert dg["handoffs"] > 0 and dg["requests"] == 8
    assert_same_keys(dg, jax["serving"]["disagg"], "serving.disagg")
    assert sg["rounds"] > 0
    assert_same_keys(sg, jax["serving"]["spec"], "serving.spec")
    assert_same_keys(payload["serving"], jax["serving"], "serving")
    assert_same_keys(payload["warmstart"], jax["warmstart"], "warmstart")
    assert payload["warmstart"]["cold_time_to_first_step_s"] > 0
