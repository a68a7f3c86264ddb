"""Multi-process support over `torch.distributed` (twin of
`flexflow_tpu/distributed.py`).

One process a device, every process running the same program (the
reference's control-replicated Legion top-level task; JAX's
multi-controller mode). `initialize` starts the process group: from the
environment `torchrun` sets (`env://`: MASTER_ADDR, MASTER_PORT, RANK,
WORLD_SIZE), or from an explicit `coordinator_address`. The backend is
"nccl" for a CUDA device and "gloo" for the CPU unless the caller names
one. After it, `FFConfig` reads the world size, `--mesh` lays the ranks
over the mesh axes, and a plan decided on rank 0 reaches every rank as a
serialized Strategy (`run_search_on_host0`).

A model on a sub-mesh (an elastic shrink: `machine.build_mesh(...,
ranks=...)`) scopes these helpers to the mesh's ranks (`set_scope`):
`process_count`, `process_index`, `is_coordinator`, `barrier`,
`broadcast_json` and `gather_json` then speak of its members only, over
its host group, so the parked ranks reach none of them. `world_size`
and `world_rank` stay the whole world's.
"""

from __future__ import annotations

import contextlib
import os
from typing import Callable, Optional

import torch.distributed as dist


def initialize(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    backend: Optional[str] = None,
    device: str = "cuda",
):
    """Start the process group (once per process, before building a
    model). Without arguments it reads `torchrun`'s environment; with
    `coordinator_address` ("host:port") it needs `num_processes` and
    `process_id`. Under NCCL the current CUDA device becomes this rank's
    card, `LOCAL_RANK` (else `process_id`)."""
    if backend is None:
        backend = "nccl" if str(device).startswith("cuda") else "gloo"
    if backend == "nccl":
        import torch

        # NCCL binds a communicator to the current device: this rank's
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK",
                                                 process_id or 0)))
    if coordinator_address is None:
        dist.init_process_group(backend, init_method="env://")
        return
    if num_processes is None or process_id is None:
        raise ValueError("coordinator_address needs num_processes and "
                         "process_id")
    dist.init_process_group(
        backend, init_method=f"tcp://{coordinator_address}",
        world_size=int(num_processes), rank=int(process_id))


# the sub-mesh (machine.Mesh with `sub`) the helpers below are scoped
# to, else None: the whole world
_SCOPE = None


def set_scope(mesh):
    """Scope the helpers to the mesh a model was just placed on: its
    ranks where it is a sub-mesh, the whole world where it spans it; a
    plain mesh of one device (each rank its own) leaves the scope as it
    is (a model's `_build_mesh` and an elastic rollback call it)."""
    global _SCOPE
    if getattr(mesh, "sub", False):
        _SCOPE = mesh
    elif mesh.size > 1:
        _SCOPE = None


def scope():
    """The sub-mesh the helpers are scoped to, or None."""
    return _SCOPE


@contextlib.contextmanager
def keep_scope():
    """The helpers' scope as it was before the block, after it: a serving
    engine's decode compile on a window of the world scopes them to the
    window while it compiles, and leaves the caller's scope as it found
    it."""
    global _SCOPE
    saved = _SCOPE
    try:
        yield
    finally:
        _SCOPE = saved


def world_size() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def world_rank() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def process_count() -> int:
    if _SCOPE is not None:
        return len(_SCOPE.ranks)
    return world_size()


def process_index() -> int:
    """This rank's index among the scope's ranks (-1 on a parked rank)."""
    if _SCOPE is not None:
        r = world_rank()
        return _SCOPE.ranks.index(r) if r in _SCOPE.ranks else -1
    return world_rank()


def local_rank() -> int:
    """This process's device index on its host: `LOCAL_RANK` as torchrun
    sets it, else the global rank."""
    return int(os.environ.get("LOCAL_RANK", world_rank()))


def is_coordinator() -> bool:
    return process_index() == 0


def _scope_args() -> dict:
    """The group and source rank of a scoped collective."""
    if _SCOPE is None:
        return {}
    return {"group": _SCOPE.host_group, "src": _SCOPE.ranks[0]}


def barrier(name: str = "barrier"):
    """Synchronization point of the scope's ranks (a no-op in one)."""
    if process_count() > 1:
        dist.barrier(group=_scope_args().get("group"))


_ERR_KEY = "__broadcast_error__"


def broadcast_json(payload: Optional[dict], max_bytes: int = 1 << 20) -> dict:
    """A JSON-serializable dict from rank 0 to every rank. A failure on
    rank 0 (too large, not serializable) reaches every rank as an error
    marker, so all raise together instead of one hanging."""
    import json

    if process_count() <= 1:
        assert payload is not None
        return payload
    box = [None]
    if is_coordinator():
        try:
            raw = json.dumps(payload)
            if len(raw) + 4 > max_bytes:
                raise ValueError(
                    f"payload {len(raw)}B exceeds broadcast buffer "
                    f"{max_bytes}B — pass a larger max_bytes")
            box[0] = raw
        except Exception as e:
            box[0] = json.dumps({_ERR_KEY: f"{type(e).__name__}: {e}"})
    args = _scope_args()
    dist.broadcast_object_list(box, src=args.get("src", 0),
                               group=args.get("group"))
    data = json.loads(box[0])
    if isinstance(data, dict) and _ERR_KEY in data:
        raise RuntimeError(data[_ERR_KEY])
    return data


def gather_json(payload: dict, max_bytes: int = 1 << 20) -> list:
    """One JSON-serializable dict per rank, gathered on every rank in
    rank order; a rank's serialization failure becomes {}."""
    import json

    if process_count() <= 1:
        return [payload]
    try:
        raw = json.dumps(payload)
        if len(raw) + 4 > max_bytes:
            raise ValueError("payload too large")
    except Exception:
        raw = "{}"
    out = [None] * process_count()
    dist.all_gather_object(out, raw, group=_scope_args().get("group"))
    return [json.loads(r) for r in out]


def share_object(payload, src: int, ranks: list, *meshes):
    """`payload` (any picklable object) from world rank `src` to every
    world rank of `ranks`: the whole world, or the ranks of one of the
    sub-meshes `meshes` (over its host group). Collective over `ranks`;
    an elastic re-plan's agreed decisions and plans travel this way."""
    if len(ranks) <= 1:
        return payload
    group = None  # the whole world
    if list(ranks) != list(range(world_size())):
        group = next(m.host_group for m in meshes
                     if getattr(m, "sub", False)
                     and sorted(m.ranks) == sorted(ranks))
    box = [payload]
    dist.broadcast_object_list(box, src=src, group=group)
    return box[0]


_WORLD_HOST = []


def world_host_group():
    """A gloo group over the whole world for host values (the default
    group where the world runs gloo), made at its first call, which must
    come on every rank at one point (the serving engines make it when
    they are built). None in a world of one."""
    if world_size() <= 1:
        return None
    if not _WORLD_HOST:
        _WORLD_HOST.append(None if dist.get_backend() == "gloo"
                           else dist.new_group(backend="gloo"))
    return _WORLD_HOST[0]


def host_broadcast(t, src: int):
    """A CPU tensor from world rank `src` to every world rank, in place,
    over the world's host group (collective over the world)."""
    if world_size() > 1:
        dist.broadcast(t, src=src, group=world_host_group())
    return t


def host_broadcast_object(obj, src: int):
    """Any picklable object from world rank `src` to every world rank
    over the world's host group (collective over the world)."""
    if world_size() <= 1:
        return obj
    box = [obj]
    dist.broadcast_object_list(box, src=src, group=world_host_group())
    return box[0]


def gather_merged_snapshot(session) -> dict:
    """The world's merged metrics snapshot (collective)."""
    from .telemetry.metrics import merge_snapshots

    return merge_snapshots(gather_json(session.collect_snapshot()))


def run_search_on_host0(search_fn: Callable[[], "object"]) -> dict:
    """Run `search_fn` (returning a Strategy) on rank 0 only; every rank
    receives the serialized plan (a failure on rank 0 raises on every
    rank). Returns the Strategy's overrides."""
    from .parallel.strategies import Strategy

    payload = None
    if process_count() <= 1 or is_coordinator():
        try:
            payload = search_fn().to_json()
        except Exception as e:
            if process_count() <= 1:
                raise
            payload = {_ERR_KEY: f"search failed on process 0: "
                       f"{type(e).__name__}: {e}"}
    data = broadcast_json(payload)
    return Strategy.from_json(data).overrides


def _spawned(rank, world, port, fn, args, queue):
    import traceback

    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world),
                      LOCAL_RANK=str(rank), MASTER_ADDR="localhost",
                      MASTER_PORT=str(port))
    try:
        import torch

        torch.set_num_threads(1)
        dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                                world_size=world, rank=rank)
        out = fn(rank, *args)
    except Exception:
        queue.put((rank, False, traceback.format_exc()))
        return
    queue.put((rank, True, out))
    try:
        dist.barrier()
        dist.destroy_process_group()
    except Exception:  # a group a refused collective left broken
        pass


def free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def spawn(fn, nprocs: int, *args, timeout: float = 600.0) -> list:
    """Run `fn(rank, *args)` in `nprocs` fresh processes joined in a gloo
    process group over localhost (the CPU twin of `torchrun
    --nproc-per-node`); returns their results in rank order, or raises
    with the first failing rank's traceback. `fn` must be importable (a
    module-level function)."""
    import multiprocessing as mp
    import queue as queue_mod

    ctx = mp.get_context("spawn")
    q = ctx.Queue()
    port = free_port()
    procs = [ctx.Process(target=_spawned,
                         args=(r, nprocs, port, fn, args, q), daemon=True)
             for r in range(nprocs)]
    for p in procs:
        p.start()
    import time

    results: dict = {}
    deadline = time.monotonic() + timeout
    try:
        while len(results) < nprocs:
            try:
                rank, ok, out = q.get(timeout=1.0)
            except queue_mod.Empty:
                dead = [r for r, p in enumerate(procs)
                        if r not in results and not p.is_alive()]
                if dead:
                    # a rank killed outright (a native abort) reports nothing
                    raise RuntimeError(
                        f"spawn: rank {dead[0]} exited with code "
                        f"{procs[dead[0]].exitcode} before giving a "
                        f"result") from None
                if time.monotonic() > deadline:
                    raise RuntimeError(
                        f"spawn: {nprocs - len(results)} ranks gave no "
                        f"result in {timeout} s") from None
                continue
            if not ok:
                raise RuntimeError(f"rank {rank} failed:\n{out}")
            results[rank] = out
    finally:
        # after a failure the other ranks may wait on the lost one forever
        done = len(results) == nprocs
        for p in procs:
            p.join(timeout=30 if done else 1)
            if p.is_alive():
                p.kill()
    return [results[r] for r in range(nprocs)]
