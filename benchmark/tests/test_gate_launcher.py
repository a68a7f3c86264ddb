"""A cell on four chips: one process per card, rank 0's line printed,
rehearsed on four gloo ranks of the CPU."""

import json
import sys
import textwrap

import launcher

RANK_SCRIPT = textwrap.dedent("""
    import json, os, sys
    import torch, torch.distributed as dist
    dist.init_process_group("gloo", init_method="env://")
    r = dist.get_rank()
    x = torch.tensor([float(r + 1)])
    dist.all_reduce(x)
    if r == int(os.environ.get("FAIL_RANK", "-1")):
        sys.exit(5)
    print(json.dumps({"rank": r, "world": dist.get_world_size(),
                      "sum": float(x)}))
    print(f"rank {r} done", file=sys.stderr)
    dist.destroy_process_group()
""")


def test_four_ranks_rank_zero_prints(tmp_path, capsys):
    script = tmp_path / "rank.py"
    script.write_text(RANK_SCRIPT)
    code = launcher.launch(script, [], 4, timeout=240)
    out, err = capsys.readouterr()
    assert code == 0, err
    line = json.loads(out.strip().splitlines()[-1])
    assert line == {"rank": 0, "world": 4, "sum": 10.0}
    assert err.strip().endswith("rank 0 done")


def test_a_failed_rank_fails_the_run(tmp_path, capsys, monkeypatch):
    script = tmp_path / "rank.py"
    script.write_text(RANK_SCRIPT)
    monkeypatch.setenv("FAIL_RANK", "2")
    code = launcher.launch(script, [], 4, timeout=240)
    out, _ = capsys.readouterr()
    assert code != 0 and out == ""


def test_rank_env_is_a_torchrun_world():
    env = launcher.rank_env(3, 4, 29555, base={})
    assert env["RANK"] == "3" and env["LOCAL_RANK"] == "3"
    assert env["WORLD_SIZE"] == "4" and env["MASTER_PORT"] == "29555"
    assert sys.executable
