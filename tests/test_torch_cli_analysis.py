"""The port's analysis CLIs — `fflint_torch.py`, `ffcheck_torch.py`,
`ffrules_torch.py` — against the JAX package's `scripts/fflint.py`,
`scripts/ffcheck.py` and `scripts/ffrules.py`, on the CPU.

- fflint: both trees lint clean through their CLI (exit 0), an unknown
  rule exits 2 in both, and each port rule's planted torch-idiom snippet
  exits 1 naming that rule while its fixed form exits 0;
- ffcheck `--sources all --self-test` on 8 gloo ranks at the JAX CI mesh
  (2, 4, 1, 1) against the JAX script on its 8 virtual devices: per
  source the same error/warning/info counts, passes and finding codes
  (severity:code); per self-test class the same finding; on one rank the
  searched sources are skipped under `all`, refused when named, and the
  self-test (placed on a mesh of absent ranks) catches every class; the
  suites (longcontext, wus) verify clean on 4 gloo ranks as JAX's do;
- ffrules `--no-oracle` over the full registry at `--mesh 2,4,1,1`: the
  same sweep summary, registry fingerprint and self-test verdicts as the
  JAX script's; the port's run with the oracle (the CPU) clean, its
  numeric-divergence class caught and its load gate refusing.

The JAX scripts run in this process (the test session's 8 virtual
devices are their CI mesh); exact equality throughout (counts, codes,
hashes).
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


def _load(path: str, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _twin(name: str):
    return _load(os.path.join(REPO, f"{name}_torch.py"), f"{name}_torch")


def _jax_script(name: str):
    return _load(os.path.join(REPO, "scripts", f"{name}.py"),
                 f"jax_{name}_under_test")


def _jax_main(mod, argv) -> int:
    """A JAX script's main() in this process on `argv`: its exit code."""
    old = sys.argv
    sys.argv = [mod.__name__, *argv]
    try:
        out = mod.main()
    except SystemExit as e:
        return int(e.code or 0)
    finally:
        sys.argv = old
    return int(out or 0)


def _quiet(fn, *args):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf), contextlib.redirect_stderr(buf):
        out = fn(*args)
    return out, buf.getvalue()


# ---------------------------------------------------------------- fflint

def test_fflint_trees_clean_in_both_clis():
    twin = _twin("fflint")
    rc, text = _quiet(twin.main, [])
    assert rc == 0, text
    assert "fflint: clean" in text
    # the default paths take in every root *_torch.py, the card's smoke
    # and the kernel sweep
    names = {os.path.basename(p) for p in twin.default_paths()}
    assert {"ffcheck_torch.py", "serve_bench_torch.py", "chip_smoke.py",
            "kernel_sweep.py", "flexflow_tpu_torch"} <= names
    assert _jax_main(_jax_script("fflint"), []) == 0


def test_fflint_unknown_rule_exits_2_in_both():
    assert _quiet(_twin("fflint").main, ["--select", "nope"])[0] == 2
    assert _jax_main(_jax_script("fflint"), ["--select", "nope"]) == 2


def _lint_cases():
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from test_torch_analysis import LINT

    return LINT


@pytest.mark.parametrize("rule", sorted(_lint_cases()))
def test_fflint_cli_catches_each_planted_snippet(tmp_path, rule):
    bad, good = _lint_cases()[rule]
    # under a port path: the op-scope rule reads executor.py and ops/
    pkg = tmp_path / "flexflow_tpu_torch"
    pkg.mkdir()
    twin = _twin("fflint")
    (pkg / "executor.py").write_text(bad)
    rc, text = _quiet(twin.main, [str(pkg), "--select", rule])
    assert rc == 1 and f" {rule} [" in text, text
    (pkg / "executor.py").write_text(good)
    rc, text = _quiet(twin.main, [str(pkg), "--select", rule])
    assert rc == 0, text


# --------------------------------------------------------------- ffcheck

@contextlib.contextmanager
def _jax_cache_config_kept():
    """The JAX package's persistent-cache settings as they were before the
    block: its cache source points them into ffcheck's temporary
    directory, which the script deletes."""
    import jax
    from jax._src import compilation_cache

    keys = ("jax_compilation_cache_dir",
            "jax_persistent_cache_min_compile_time_secs",
            "jax_persistent_cache_min_entry_size_bytes")
    saved = {k: getattr(jax.config, k) for k in keys}
    try:
        yield
    finally:
        for k, v in saved.items():
            jax.config.update(k, v)
        compilation_cache.reset_cache()


def ffcheck_rank(rank, report):
    import ffcheck_torch

    return ffcheck_torch.main(["--device", "cpu", "--report", report])


def test_ffcheck_sources_and_self_test_match_jax(tmp_path):
    from flexflow_tpu_torch.distributed import spawn

    sys.path.insert(0, REPO)
    port_report = str(tmp_path / "port.json")
    assert spawn(ffcheck_rank, 8, port_report, timeout=240) == [0] * 8
    port = json.load(open(port_report))

    mod = _jax_script("ffcheck")
    codes = {}
    check_clean = mod._check_clean

    def spy(ff, source):
        codes[source] = sorted({f"{f.severity}:{f.code}"
                                for f in ff._analysis.findings})
        return check_clean(ff, source)

    mod._check_clean = spy
    jax_report = str(tmp_path / "jax.json")
    with _jax_cache_config_kept():
        assert _quiet(_jax_main, mod, ["--report", jax_report])[0] == 0
    want = json.load(open(jax_report))

    assert port["ok"] and want["ok"] and port["mesh"] == [2, 4, 1, 1]
    keys = ("plan_source", "errors", "warnings", "info", "passes_run")
    assert ([{k: e[k] for k in keys} for e in port["sources"]]
            == [{k: e[k] for k in keys} for e in want["sources"]])
    assert {e["plan_source"]: e["codes"] for e in port["sources"]} == codes
    assert port["self_test"] == want["self_test"]


def test_ffcheck_one_rank_skips_searched_sources(tmp_path):
    twin = _twin("ffcheck")
    report = str(tmp_path / "one.json")
    rc, text = _quiet(twin.main, ["--device", "cpu", "--report", report])
    assert rc == 0, text
    rep = json.load(open(report))
    skipped = sorted(e["plan_source"] for e in rep["sources"]
                     if "skipped" in e)
    assert skipped == ["cache", "checkpoint", "search"]
    assert all(e["errors"] == 0 for e in rep["sources"] if "skipped" not in e)
    assert [e["class"] for e in rep["self_test"]] == [
        "axis_reuse", "dropped_parallel_op", "oversharded_dim",
        "non_bijective_permutation", "donated_then_reused",
        "coordinator_collective", "parallel_dtype_mismatch",
        "master_bypass", "low_precision_accum_graph",
        "low_precision_accum_src", "host_divergent_branch",
        "spmd_fingerprint_mismatch"]
    rc, text = _quiet(twin.main, ["--device", "cpu", "--sources", "search",
                                  "--no-self-test"])
    assert rc == 1 and "need a mesh of 2+ ranks" in text
    rc, text = _quiet(twin.main, ["--device", "cpu", "--sources", "none",
                                  "--no-self-test", "--suite", "wus"])
    assert rc == 1 and "mesh of 4 ranks" in text
    assert _quiet(twin.main, ["--bogus"])[0] == 1


# --------------------------------------------------------------- ffrules

def test_ffrules_no_oracle_sweep_matches_jax(tmp_path):
    port_report, jax_report = (str(tmp_path / f"{p}.json")
                               for p in ("port", "jax"))
    argv = ["--no-oracle", "--mesh", "2,4,1,1"]
    rc, text = _quiet(_twin("ffrules").main,
                      [*argv, "--device", "cpu", "--report", port_report])
    assert rc == 0, text
    assert _quiet(_jax_main, _jax_script("ffrules"),
                  [*argv, "--report", jax_report])[0] == 0
    port, want = (json.load(open(p)) for p in (port_report, jax_report))
    for k in ("mesh", "fingerprint", "errors", "warnings", "info",
              "passes_run"):
        assert port["sweep"][k] == want["sweep"][k], k
    assert port["self_test"] == want["self_test"]
    assert "load_gate" not in port and "load_gate" not in want


def test_ffrules_with_the_oracle_on_the_cpu(tmp_path):
    report = str(tmp_path / "port.json")
    rc, text = _quiet(_twin("ffrules").main,
                      ["--device", "cpu", "--report", report])
    assert rc == 0, text
    rep = json.load(open(report))
    assert rep["ok"] and rep["sweep"]["errors"] == 0
    assert {"class": "numeric_divergence",
            "finding": "rule_numeric_divergence"} in rep["self_test"]
    assert rep["load_gate"] == {"refused": True, "downgrade_recorded": True}


def suites_rank(rank, report):
    import ffcheck_torch

    return ffcheck_torch.main(["--device", "cpu", "--sources", "none",
                               "--no-self-test", "--suite", "longcontext",
                               "--suite", "wus", "--report", report])


def test_ffcheck_suites_on_four_ranks_as_jax(tmp_path):
    """The long-context ring plan over seq 4 and the memory-capped dp 4
    plan (its update sharding chosen) verify clean on 4 gloo ranks, as
    the JAX script's suites do on its virtual devices."""
    from flexflow_tpu_torch.distributed import spawn

    sys.path.insert(0, REPO)
    port_report = str(tmp_path / "port.json")
    assert spawn(suites_rank, 4, port_report, timeout=240) == [0] * 4
    jax_report = str(tmp_path / "jax.json")
    argv = ["--sources", "none", "--no-self-test", "--suite", "longcontext",
            "--suite", "wus", "--report", jax_report]
    assert _quiet(_jax_main, _jax_script("ffcheck"), argv)[0] == 0
    port, want = (json.load(open(p)) for p in (port_report, jax_report))
    assert port["suites"] == want["suites"] == [
        {"suite": "longcontext", "ok": True}, {"suite": "wus", "ok": True}]
