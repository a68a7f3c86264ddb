"""One process per card for a cell on several chips.

`launch` starts `script` once per rank with the environment a torchrun
world has (RANK, LOCAL_RANK, WORLD_SIZE, LOCAL_WORLD_SIZE, MASTER_ADDR,
MASTER_PORT on a free local port), waits for every rank, and prints rank
0's standard output and the tail of every rank's standard error. It
returns 0 only when every rank did; a rank that fails ends the others.
"""

from __future__ import annotations

import os
import socket
import subprocess
import sys
import tempfile
import time


def free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def rank_env(rank: int, world: int, port: int, base=None) -> dict:
    env = dict(os.environ if base is None else base)
    env.update(RANK=str(rank), LOCAL_RANK=str(rank), WORLD_SIZE=str(world),
               LOCAL_WORLD_SIZE=str(world), GROUP_RANK="0",
               MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port))
    return env


def launch(script, argv, world: int, timeout: float = 3000.0,
           base_env=None) -> int:
    port = free_port()
    procs, outs = [], []
    with tempfile.TemporaryDirectory() as d:
        for r in range(world):
            out = open(os.path.join(d, f"out{r}"), "w+")
            err = open(os.path.join(d, f"err{r}"), "w+")
            outs.append((out, err))
            procs.append(subprocess.Popen(
                [sys.executable, str(script), *argv], stdout=out, stderr=err,
                env=rank_env(r, world, port, base_env)))
        deadline = time.monotonic() + timeout
        codes = [None] * world
        while None in codes:
            for i, p in enumerate(procs):
                if codes[i] is None:
                    codes[i] = p.poll()
            if any(c not in (None, 0) for c in codes) \
                    or time.monotonic() > deadline:
                for p in procs:
                    if p.poll() is None:
                        p.terminate()
                for p in procs:
                    try:
                        p.wait(timeout=30)
                    except subprocess.TimeoutExpired:
                        p.kill()
                        p.wait()
                codes = [p.returncode for p in procs]
                break
            time.sleep(0.05)
        # rank 0's last, so its checks end standard error
        for r in list(range(1, world)) + [0]:
            err = outs[r][1]
            err.seek(0)
            tail = err.read()[-4000:]
            if tail:
                sys.stderr.write(f"--- rank {r} stderr ---\n{tail}")
            err.close()
        out0 = outs[0][0]
        out0.seek(0)
        rank0 = out0.read()
        for out, _ in outs:
            out.close()
    if all(c == 0 for c in codes):
        sys.stdout.write(rank0)
        sys.stdout.flush()
        return 0
    sys.stderr.write(f"rank exit codes {codes}\n")
    return next(c for c in codes if c) or 1
