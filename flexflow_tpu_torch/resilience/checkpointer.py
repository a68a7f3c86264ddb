"""Async atomic checkpoint writer (twin of
`flexflow_tpu/resilience/checkpointer.py`, same layout and file format).

Layout under a checkpoint root directory:

    <root>/
      step_00000012/            # one committed checkpoint
        arrays.npz              # flat keystr path -> host array bytes
        manifest.json           # {"committed": true, "step": ...,
                                #  "leaves": {path: {key, dtype, shape}},
                                #  "extras": {...}}
      .tmp-step_00000024-<pid>/ # in-flight write, never read by restore
      LATEST                    # convenience pointer (informational)

A checkpoint written by either package is read by the other: the leaf
paths are `jax.tree_util.keystr`'s (`['params']['fc1']['kernel']`), made
here from nested dicts, and the manifest schema is the same. bfloat16
leaves are written as JAX writes them, raw 2-byte words (numpy has no
bfloat16; npz keeps them as void `V2`) with `"dtype": "bfloat16"` in the
manifest, and read back through a 16-bit integer view into
`torch.bfloat16`, with no `ml_dtypes`.

Commit protocol (CheckFreq-style decoupled persistence):

1. the train loop snapshots device state to host: on the card a copy into
   pinned host buffers, queued on the current stream (the one a captured
   step replays on) after the step, with an event marking its end. The
   next step, queued behind it on the same stream, cannot overwrite a
   master before the copy has read it. On the CPU the leaves are cloned;
2. a background writer thread waits on that event before it reads a byte,
   serializes everything into a `.tmp-*` directory and fsyncs the files
   and the directory;
3. several ranks: every rank reaches a barrier, then **rank 0 alone**
   renames the tmp dir to its final `step_*` name (`os.replace`, atomic
   on POSIX) and rewrites LATEST. The rename is the commit point: a kill
   at any earlier moment leaves only a `.tmp-*` dir that discovery
   ignores. Under a process group of more than one rank the save runs in
   the caller's thread (the barrier is a collective, and a collective
   from a second thread would race the step's own); the caller gathers
   sharded state into whole arrays first (`reshard.logical_state_tree`).

`manifest.json` is written *last* inside the tmp dir, so a torn rename
cannot surface a half-written checkpoint: discovery requires a parseable
manifest with "committed": true.
"""

from __future__ import annotations

import json
import os
import re
import shutil
import threading
import time
from typing import Any, Callable, Optional

import numpy as np
import torch

from .. import telemetry

_STEP_DIR = re.compile(r"^step_(\d{8,})$")  # %08d grows past 8 digits ≥1e8
_TMP_PREFIX = ".tmp-"


class CheckpointCorruptError(RuntimeError):
    """A checkpoint directory failed integrity checks on load."""


def _step_dirname(step: int) -> str:
    return f"step_{int(step):08d}"


def _fsync_dir(path: str):
    try:
        fd = os.open(path, os.O_RDONLY)
        try:
            os.fsync(fd)
        finally:
            os.close(fd)
    except OSError:  # pragma: no cover - fsync of dirs unsupported somewhere
        pass


def _keystr(path: tuple) -> str:
    """`jax.tree_util.keystr` of a path of dict keys and sequence
    indices: `['params'][0]`."""
    return "".join(f"[{k}]" if isinstance(k, int) else f"[{k!r}]"
                   for k in path)


def tree_items(tree, path=()):
    """(path, leaf) of every leaf of nested dicts, lists and tuples, in
    order; None is an empty subtree, as in a JAX pytree."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from tree_items(v, path + (k,))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from tree_items(v, path + (i,))
    elif tree is not None:
        yield path, tree


def flatten_tree(tree) -> dict[str, Any]:
    """Flatten nested dicts into {keystr path: leaf}. The keystr form (e.g.
    "['params']['fc1']['kernel']") is the stable on-disk naming, the JAX
    package's: restore matches against the target model's identically
    flattened template, so resharding never needs to parse paths."""
    return {_keystr(p): leaf for p, leaf in tree_items(tree)}


def _host_copy(leaf):
    """A detached host copy of one leaf (torch tensors stay torch: numpy
    has no bfloat16)."""
    if torch.is_tensor(leaf):
        return leaf.detach().to("cpu", copy=True)
    return np.array(leaf)


def snapshot_to_host(tree) -> dict[str, Any]:
    """Copy-on-snapshot, synchronously: {path: host copy} (a CPU tensor
    for a tensor leaf, numpy otherwise), so the caller may overwrite the
    device tensors right after. `AsyncCheckpointer.save` takes the
    asynchronous route (pinned buffers and an event)."""
    return {k: _host_copy(v) for k, v in flatten_tree(tree).items()}


def _dtype_name(leaf) -> str:
    if torch.is_tensor(leaf):
        return str(leaf.dtype).replace("torch.", "")
    return str(np.asarray(leaf).dtype)


def _to_numpy(leaf) -> np.ndarray:
    """npz-safe bytes of one host leaf: bfloat16 as void 2-byte words."""
    if torch.is_tensor(leaf):
        if leaf.dtype == torch.bfloat16:
            return leaf.view(torch.int16).numpy().view(np.dtype("V2"))
        return leaf.numpy()
    return np.asarray(leaf)


def _encode_leaves(flat: dict):
    """npz-safe arrays + true-dtype manifest entries."""
    arrays, leaves = {}, {}
    for i, (path, leaf) in enumerate(sorted(flat.items())):
        key = f"a{i}"
        leaves[path] = {
            "key": key,
            "dtype": _dtype_name(leaf),
            "shape": list(leaf.shape) if hasattr(leaf, "shape")
            else list(np.shape(leaf)),
        }
        arrays[key] = _to_numpy(leaf)
    return arrays, leaves


def _decode_leaf(raw: np.ndarray, meta: dict):
    """One stored leaf: numpy, but a bfloat16 leaf as a CPU
    torch.bfloat16 tensor (numpy cannot hold it)."""
    shape = tuple(meta["shape"])
    if meta["dtype"] == "bfloat16":
        words = np.frombuffer(raw.tobytes(), dtype=np.int16).reshape(shape)
        return torch.from_numpy(words.copy()).view(torch.bfloat16)
    dtype = np.dtype(meta["dtype"])
    if raw.dtype == dtype:
        return raw.reshape(shape)
    # npz degraded a non-native dtype to void bytes: re-view
    return np.frombuffer(raw.tobytes(), dtype=dtype).reshape(shape)


def list_checkpoints(root: str) -> list[str]:
    """Committed checkpoint paths under `root`, oldest first. A step dir
    only counts when its manifest parses and says committed."""
    if not os.path.isdir(root):
        return []
    found = []
    for name in os.listdir(root):
        m = _STEP_DIR.match(name)
        if not m:
            continue
        path = os.path.join(root, name)
        try:
            with open(os.path.join(path, "manifest.json")) as f:
                manifest = json.load(f)
            if manifest.get("committed"):
                found.append((int(m.group(1)), path))
        except (OSError, ValueError):
            continue
    return [p for _, p in sorted(found)]


def latest_checkpoint(root: str) -> Optional[str]:
    """Newest committed checkpoint under `root`, or None."""
    ckpts = list_checkpoints(root)
    return ckpts[-1] if ckpts else None


def load_checkpoint(path: str) -> tuple[dict, dict]:
    """Read one committed checkpoint dir -> (flat {path: host array},
    manifest); a bfloat16 leaf is a CPU torch.bfloat16 tensor. Raises
    CheckpointCorruptError on integrity failures."""
    try:
        with open(os.path.join(path, "manifest.json")) as f:
            manifest = json.load(f)
    except (OSError, ValueError) as e:
        raise CheckpointCorruptError(f"{path}: unreadable manifest: {e}")
    if not manifest.get("committed"):
        raise CheckpointCorruptError(f"{path}: manifest not committed")
    try:
        with np.load(os.path.join(path, "arrays.npz")) as z:
            flat = {
                p: _decode_leaf(z[meta["key"]], meta)
                for p, meta in manifest["leaves"].items()
            }
    except (OSError, ValueError, KeyError) as e:
        raise CheckpointCorruptError(f"{path}: unreadable arrays: {e}")
    return flat, manifest


def _nbytes(leaf) -> int:
    if torch.is_tensor(leaf):
        return leaf.numel() * leaf.element_size()
    return int(np.asarray(leaf).nbytes)


class AsyncCheckpointer:
    """Background checkpoint writer with atomic commit.

    At most one save is in flight; a new save first drains the previous one
    (bounded memory: one host snapshot alive at a time, in pinned buffers
    this checkpointer keeps and reuses). `wait()` re-raises any
    writer-thread failure: a silent failed save must not masquerade as
    durability."""

    def __init__(self, root: str, keep: int = 3,
                 barrier_fn: Optional[Callable[[str], None]] = None,
                 is_committer: Optional[Callable[[], bool]] = None):
        self.root = os.path.abspath(root)
        self.keep = int(keep)
        from ..distributed import barrier, is_coordinator

        self._barrier = barrier_fn or barrier
        self._is_committer = is_committer or is_coordinator
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None
        self._aborted = threading.Event()
        self.last_committed: Optional[str] = None
        # test hook: called between serialization and commit (fault point)
        self._pre_commit_hook: Optional[Callable[[str], None]] = None
        # telemetry: blocking-snapshot latency of the save in flight, and
        # the previous commit's wall time (checkpoint staleness)
        self._snapshot_s = 0.0
        self._last_commit_t: Optional[float] = None
        # the last commit's durations (serialize, commit) and bytes
        self.last_write: dict = {}
        # path -> pinned host buffer of a device leaf, reused by later
        # saves (the previous save is drained before a new one fills them)
        self._pinned: dict[str, torch.Tensor] = {}

    # ------------------------------------------------------------ save

    def _snapshot(self, flat: dict):
        """{path: host leaf} and the event that marks the end of the
        device-to-host copies (None when no leaf is on a device). Device
        leaves are copied into pinned buffers on the current stream,
        asynchronously; host leaves are copied at once."""
        host, event = {}, None
        for path, leaf in flat.items():
            if torch.is_tensor(leaf) and leaf.is_cuda:
                buf = self._pinned.get(path)
                if (buf is None or buf.shape != leaf.shape
                        or buf.dtype != leaf.dtype):
                    buf = self._pinned[path] = torch.empty(
                        leaf.shape, dtype=leaf.dtype, pin_memory=True)
                buf.copy_(leaf.detach(), non_blocking=True)
                host[path] = buf
                if event is None:
                    event = torch.cuda.Event()
            else:
                host[path] = _host_copy(leaf)
        if event is not None:
            event.record()  # on the current stream, after every copy
        return host, event

    def save(self, step: int, tree, extras: Optional[dict] = None,
             blocking: bool = False) -> None:
        """Snapshot `tree` (whole tensors: under several ranks the caller
        has gathered its shards) and persist it as step `step`. The
        snapshot is queued here; the write and commit happen on a
        background thread unless `blocking` or the process group has
        more than one rank (its commit barrier is a collective, issued
        from this thread, at the same step on every rank)."""
        from ..distributed import process_count

        self.wait()  # drain previous save; raises its error if any
        t_snap0 = time.perf_counter()
        with telemetry.span("ckpt.snapshot", step=int(step)):
            host, ready = self._snapshot(flatten_tree(tree))
        self._snapshot_s = time.perf_counter() - t_snap0
        extras = dict(extras or {})
        if blocking or process_count() > 1:
            self._write(step, host, extras, ready)
            return
        self._thread = threading.Thread(
            target=self._write_guarded, args=(step, host, extras, ready),
            name=f"ckpt-writer-{step}", daemon=True)
        self._thread.start()

    def _write_guarded(self, step, host, extras, ready):
        try:
            self._write(step, host, extras, ready)
        except BaseException as e:  # surfaced by wait()
            self._error = e

    def _write(self, step: int, host: dict, extras: dict, ready=None):
        if ready is not None:
            # the device-to-host copies end here: no byte is read before
            ready.synchronize()
        final = os.path.join(self.root, _step_dirname(step))
        # only the committer serializes: every rank holds the identical
        # whole arrays. A serialization failure (ENOSPC...) must NOT raise
        # before the barriers: the other ranks already wait in the
        # collective and would hang. Record it, join the barriers, skip
        # the commit, raise after.
        tmp = None
        error: Optional[BaseException] = None
        t_ser0 = time.perf_counter()
        if self._is_committer():
            try:
                with telemetry.span("ckpt.serialize", step=int(step)):
                    os.makedirs(self.root, exist_ok=True)
                    tmp = os.path.join(
                        self.root,
                        f"{_TMP_PREFIX}{_step_dirname(step)}-{os.getpid()}")
                    if os.path.exists(tmp):
                        shutil.rmtree(tmp)
                    os.makedirs(tmp)
                    arrays, leaves = _encode_leaves(host)
                    arrays_path = os.path.join(tmp, "arrays.npz")
                    with open(arrays_path, "wb") as f:
                        np.savez(f, **arrays)
                        f.flush()
                        os.fsync(f.fileno())
                    manifest = {
                        "committed": True,
                        "step": int(step),
                        "leaves": leaves,
                        "extras": extras,
                        "format_version": 1,
                    }
                    # manifest last: its presence marks a complete
                    # serialization
                    man_path = os.path.join(tmp, "manifest.json")
                    with open(man_path, "w") as f:
                        json.dump(manifest, f)
                        f.flush()
                        os.fsync(f.fileno())
                    _fsync_dir(tmp)
                if self._pre_commit_hook is not None:
                    self._pre_commit_hook(tmp)
            except BaseException as e:
                error = e
        serialize_s = time.perf_counter() - t_ser0
        # rank 0 alone renames (concurrent renames on a shared filesystem
        # must not collide)
        t_commit0 = time.perf_counter()
        with telemetry.span("ckpt.commit", step=int(step)):
            self._barrier("ckpt-precommit")
            skip = error is not None or self._aborted.is_set()
            if self._is_committer() and not skip:
                displaced = None
                if os.path.exists(final):
                    # re-saving an existing step: move the old committed
                    # dir aside with an atomic rename FIRST, so a kill
                    # mid-swap still shows exactly one committed state
                    # (.old-* names never match discovery)
                    displaced = os.path.join(
                        self.root,
                        f".old-{_step_dirname(step)}-{os.getpid()}")
                    if os.path.exists(displaced):
                        shutil.rmtree(displaced)
                    os.replace(final, displaced)
                os.replace(tmp, final)  # THE commit point
                _fsync_dir(self.root)
                if displaced is not None:
                    shutil.rmtree(displaced, ignore_errors=True)
                self._write_latest(final)
                self._prune()
            elif skip and tmp is not None:
                # failed or aborted (simulated death): never commit; leave
                # no half-written state behind
                shutil.rmtree(tmp, ignore_errors=True)
            self._barrier("ckpt-postcommit")
        if error is not None:
            raise error
        if not skip:
            self.last_committed = final
            commit_s = time.perf_counter() - t_commit0
            now = time.monotonic()
            staleness = (now - self._last_commit_t
                         if self._last_commit_t is not None else 0.0)
            self._last_commit_t = now
            self.last_write = {
                "step": int(step), "snapshot_s": self._snapshot_s,
                "serialize_s": serialize_s, "commit_s": commit_s,
                "bytes": sum(_nbytes(v) for v in host.values())}
            if telemetry.active_session() is not None:
                telemetry.inc("checkpoints_total")
                telemetry.observe("checkpoint_commit_s", commit_s)
                telemetry.event(
                    "checkpoint", step=int(step),
                    snapshot_s=self._snapshot_s, serialize_s=serialize_s,
                    commit_s=commit_s, bytes=self.last_write["bytes"],
                    staleness_s=staleness)

    def _write_latest(self, final: str):
        tmp = os.path.join(self.root, ".LATEST.tmp")
        with open(tmp, "w") as f:
            f.write(os.path.basename(final))
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, os.path.join(self.root, "LATEST"))

    def _prune(self):
        if self.keep <= 0:
            return
        ckpts = list_checkpoints(self.root)
        for path in ckpts[:-self.keep]:
            shutil.rmtree(path, ignore_errors=True)

    # ------------------------------------------------------------ drain

    def wait(self):
        """Join the in-flight save (if any); re-raise its failure."""
        t, self._thread = self._thread, None
        if t is not None:
            t.join()
        if self._error is not None:
            e, self._error = self._error, None
            raise e

    def abort(self):
        """Discard the in-flight save as if the process had died: the
        writer must not commit after a (simulated) kill. An already-
        committed write stays committed, exactly like a real kill landing
        a moment later. The checkpointer is reusable afterwards."""
        self._aborted.set()
        try:
            t, self._thread = self._thread, None
            if t is not None:
                t.join()
            self._error = None
        finally:
            self._aborted.clear()

    def close(self):
        self.wait()
