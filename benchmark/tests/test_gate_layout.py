"""BENCHMARK.json against the schema its checker expects, and every piece
of every cell found by its name."""

import json
import re
import subprocess
import sys

import pytest

from conftest import BENCH

SPEC = json.loads((BENCH.parent / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


def test_top_level_keys():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    assert SPEC["paths"] == ["benchmark"]
    assert SPEC["command"][:2] == ["python3", "benchmark/run.py"]
    assert 1 <= SPEC["run_seconds"] <= 51
    assert len(json.dumps(SPEC)) < 64 * 1024


def test_names_units_and_keys():
    names = []
    for c in SPEC["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert (BENCH.parent / c["file"]).is_file()
        assert all(NAME.match(k) for k in c["reduced"])
        names.append(c["name"])
    for w in SPEC["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] in (1, 4) and len(w["why"]) <= 200
        names += [w["name"], w["config"], w["traffic"]]
    for m in SPEC["end_to_end"] + SPEC["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert m["source"] in SOURCES
        names.append(m["name"])
    for m in SPEC["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in SPEC["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
    assert all(NAME.match(n) for n in names)
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        ns = [x["name"] for x in SPEC[group]]
        assert len(ns) == len(set(ns))
    assert any(m["name"] == "setup_s" and m["bound"] <= 0.25
               for m in SPEC["end_to_end"])


@pytest.mark.parametrize("workload", [w["name"] for w in SPEC["workloads"]])
def test_every_piece_of_a_cell_resolves(workload):
    import harness

    cell = harness.Cell(workload, SPEC)
    assert callable(cell.kind().run)
    e2e = {m["name"] for m in cell.end_to_end}
    assert "setup_s" in e2e and len(e2e) >= 2
    assert cell.per_layer, "every cell reports a per-layer metric"
    for m in cell.per_layer:
        assert m["moves"] in e2e
        assert callable(harness.load_module("metrics", m["name"]).read)
    assert set(cell.limits) and all(v > 0 for v in cell.limits.values())


def test_every_config_and_per_layer_metric_is_used():
    used = {w["config"] for w in SPEC["workloads"]}
    assert used == {c["name"] for c in SPEC["configs"]}
    cells = {w["name"] for w in SPEC["workloads"]}
    for m in SPEC["per_layer"]:
        assert set(m.get("workloads", cells)) <= cells
        moved = next(e for e in SPEC["end_to_end"] if e["name"] == m["moves"])
        assert set(m["workloads"]) <= set(moved.get("workloads", cells))


@pytest.mark.parametrize("config", [c["name"] for c in SPEC["configs"]])
def test_config_file_states_its_cut(config):
    import harness

    c = harness.load_json("configs", config)
    entry = next(x for x in SPEC["configs"] if x["name"] == config)
    assert sorted(c["reduced"]) == sorted(entry["reduced"])
    assert c["source"] == entry["source"]
    m = c["model"]
    pub = {"gpt2-medium": ("n_embd", "n_head", "n_layer", "n_positions"),
           "gpt3-6.7b": ("d_model", "n_heads", "n_layers", "n_ctx")}[config]
    assert (m["hidden_size"], m["num_heads"], m["num_layers"],
            m["sequence_length"]) == tuple(c[k] for k in pub)
    assert c["departures"] and c["deployment"]


def test_a_cell_comes_in_as_new_files_and_entries(tmp_path):
    """A configuration, a traffic mix and a per-layer metric added by new
    files and new entries alone, in a copy of the benchmark."""
    import shutil

    root = tmp_path / "co"
    shutil.copytree(BENCH, root / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__", ".cache"))
    spec = json.loads(json.dumps(SPEC))
    b = root / "benchmark"
    cfg = json.loads((b / "configs" / "gpt2-medium.json").read_text())
    cfg["name"] = "gpt2-large"
    (b / "configs" / "gpt2-large.json").write_text(json.dumps(cfg))
    tr = json.loads((b / "traffic" / "train-32x1024-adam.json").read_text())
    tr["batch"] = 16
    (b / "traffic" / "train-16x1024-adam.json").write_text(json.dumps(tr))
    (b / "limits" / "gpt2-large.train.json").write_text(
        json.dumps({"loss_gap": 1, "grad_gap": 1, "update_gap": 1}))
    (b / "metrics" / "train.new_metric.py").write_text(
        "def read(ctx):\n    return 42.0\n")
    spec["configs"].append({"name": "gpt2-large", "source": "x",
                            "file": "benchmark/configs/gpt2-large.json",
                            "reduced": [], "why": "x"})
    spec["workloads"].append({"name": "gpt2-large.train",
                              "config": "gpt2-large",
                              "traffic": "train-16x1024-adam", "chips": 1,
                              "why": "x"})
    spec["end_to_end"][0]["workloads"].append("gpt2-large.train")
    spec["per_layer"].append({"name": "train.new_metric", "unit": "%",
                              "better": "higher", "source": "host_clock",
                              "layer": "model step",
                              "moves": "train_tokens_per_s",
                              "workloads": ["gpt2-large.train"]})
    (root / "BENCHMARK.json").write_text(json.dumps(spec))
    code = (
        "import sys; sys.path.insert(0, 'benchmark'); import harness\n"
        "c = harness.Cell('gpt2-large.train')\n"
        "assert c.traffic['batch'] == 16 and c.config['name'] == 'gpt2-large'\n"
        "m = [x['name'] for x in c.per_layer]\n"
        "assert 'train.new_metric' in m, m\n"
        "print(harness.load_module('metrics', 'train.new_metric').read({}))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=root,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "42.0"
