"""The port's serving benchmark `serve_bench_torch.py` against the JAX
package's `scripts/serve_bench.py`, on the CPU (the tiny tier: vocab 256,
hidden 64, 4 heads, 2 layers, float32).

On one shared-prefix trace (12 requests, prompt 16, 8 new tokens,
`--layout both`), closed loop and open loop (`--arrival-rate 200 --burst
4`), both scripts print the same metric lines (by name) and a payload
with the same keys (each layout's engine summary in the port adds its
unnormalized rates and its device); the values the trace determines are
equal exactly: each layout's completed count, decode and prefill token
counts, finish reasons, `prefix_hit_rate`, `cow_copies`,
`kv_hbm_bytes_per_layer`, and `slots_at_fixed_hbm` (the JAX script runs
on the session's 8 virtual devices, the port on one: the trace fixes
these counts either way). The port's completions agree across the
layouts (the script's own rule). `--disaggregate` on one process and
`--disaggregate --speculate` are refused with exit code 2. The torchrun
run's command-line legs are rehearsed on 4 gloo ranks.
"""

import contextlib
import importlib.util
import io
import json
import os
import sys

import pytest
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TRACE = ["--requests", "12", "--prompt-len", "16", "--max-new-tokens", "8",
         "--layout", "both"]
LOADS = {"closed": [], "open": ["--arrival-rate", "200", "--burst", "4"]}
PER_LAYOUT = ("requests_completed", "decode_tokens", "prefill_tokens",
              "kv_hbm_bytes_per_layer", "kv_layout", "slots",
              "max_seq_len", "no_token_requests")
ENGINE_EXTRAS = {"requests_per_sec", "decode_tokens_per_sec", "device"}
PAGED_ONLY = ("prefix_hit_rate", "cow_copies", "prefix_shared_tokens",
              "kv_block_size", "kv_pool_blocks", "kv_blocks_in_use_peak")


def _load(path: str, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _run(which: str, argv) -> dict:
    """One script on `argv` in this process: its printed lines, its exit
    code and the finish reasons of each run's completed requests."""
    path = (os.path.join(REPO, "serve_bench_torch.py") if which == "port"
            else os.path.join(REPO, "scripts", "serve_bench.py"))
    mod = _load(path, f"{which}_serve_bench_under_test")
    reasons = []
    completed = mod._completed

    def spy(engine):
        done = completed(engine)
        reasons.append(sorted(r.finish_reason for r in done))
        return done

    mod._completed = spy
    out = io.StringIO()
    old = sys.argv
    sys.argv = ["serve_bench", *argv]
    try:
        with contextlib.redirect_stdout(out):
            rc = mod.main(list(argv)) if which == "port" else mod.main()
    except SystemExit as e:
        rc = e.code
    finally:
        sys.argv = old
    lines = [json.loads(l) for l in out.getvalue().splitlines()
             if l.startswith("{")]
    return {"rc": int(rc or 0), "lines": lines, "reasons": reasons}


@pytest.mark.parametrize("load", sorted(LOADS))
def test_serve_bench_trace_counts_match_jax(load):
    argv = TRACE + LOADS[load]
    port = _run("port", argv + ["--device", "cpu"])
    jax = _run("jax", argv)
    assert port["rc"] == jax["rc"] == 0
    assert ([l.get("metric") for l in port["lines"]]
            == [l.get("metric") for l in jax["lines"]])
    got, want = port["lines"][-1], jax["lines"][-1]
    assert sorted(got) == sorted(want)
    assert got["load_model"] == want["load_model"] == load
    for k in ("shared_prefix", "requests", "prompt_len", "max_new_tokens",
              "slots_at_fixed_hbm"):
        assert got[k] == want[k], k
    for lay in ("paged", "contiguous"):
        # the port's engine summary also carries its unnormalized rates
        # and its device beside JAX's keys
        assert set(want[lay]) <= set(got[lay]), lay
        assert set(got[lay]) - set(want[lay]) <= ENGINE_EXTRAS, lay
        keys = PER_LAYOUT + (PAGED_ONLY if lay == "paged" else ())
        assert ({k: got[lay][k] for k in keys}
                == {k: want[lay][k] for k in keys}), lay
        assert got[lay]["requests_completed"] == 12
    assert port["reasons"] == jax["reasons"]
    assert len(port["reasons"]) == 2  # the measured run of each layout


def test_serve_bench_refusals():
    port = _run("port", TRACE + ["--device", "cpu", "--disaggregate"])
    assert port["rc"] == 2 and port["lines"] == []
    port = _run("port", TRACE + ["--device", "cpu", "--disaggregate",
                                 "--speculate"])
    assert port["rc"] == 2
    assert _run("jax", TRACE + ["--disaggregate", "--speculate"])["rc"] == 2


def test_serve_bench_completions_agree_across_layouts():
    sys.path.insert(0, REPO)
    mod = _load(os.path.join(REPO, "serve_bench_torch.py"),
                "port_serve_bench_payload")
    with contextlib.redirect_stdout(io.StringIO()):
        rc, payload = mod.bench(TRACE + ["--device", "cpu"])
    assert rc == 0
    done = payload["completions"]
    assert done["paged"] == done["contiguous"] and len(done["paged"]) == 12


def cli_leg_rank(rank):
    import chip_smoke

    return chip_smoke.mesh_cli_check(
        "cpu", ae_models="mlp,dlrm",
        trace=("--requests", "8", "--prompt-len", "16",
               "--max-new-tokens", "8"),
        unity_flags=("-b", "16", "--hidden", "256", "--mesh", "2,2,1,1"))


def test_mesh_cli_legs_pass_on_four_cpu_ranks():
    """The torchrun run's command-line legs (`chip_smoke.mesh_cli_check`)
    rehearsed on 4 gloo ranks at small sizes: run_ae's four results on
    rank 0, serve_bench --disaggregate (prefill 2 + decode 2) with its
    completions equal to the unified engine's (exit 0), and unity_vs_dp's
    plan the same on every rank."""
    from flexflow_tpu_torch.distributed import spawn

    sys.path.insert(0, REPO)
    outs = spawn(cli_leg_rank, 4, timeout=300)
    assert [o["failures"] for o in outs] == [[]] * 4
    assert len(outs[0]["ae"]) == 4
    assert all(o["disagg"]["disagg"]["handoffs"] == 8 for o in outs)
    assert outs[0]["unity_vs_dp"]["plan"]["nodes"]
