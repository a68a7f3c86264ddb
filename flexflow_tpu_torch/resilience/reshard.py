"""Cross-mesh elastic resume: checkpointed leaves re-placed under the
restoring model's mesh and plan (twin of
`flexflow_tpu/resilience/reshard.py`).

Checkpoints store each leaf as its full *logical* array (the save gathers
a sharded master, slot or state tensor into the whole tensor first:
`logical_state_tree`, collective), which makes them mesh-independent:
restoring onto another mesh or plan takes each rank's block of the whole
array under the *restoring* compile's placement
(`Executor.local_weight`), as JAX's `device_put` with the target
NamedSharding does. The same holds across weight-update stages (off,
stage 2, stage 3): the restoring compile's at-rest layout decides the
block. The manifest's `extras.update_sharding` records how the writer ran.

Restore writes into the tensors the model holds, in place (`copy_`): a
captured step reads and writes those very tensors, so its CUDA graphs stay
valid and no capture is paid again. The generator's state (`['rng']`) is
`torch.Generator.get_state()`, marked `"rng_kind": "torch"` in the extras;
the JAX package's is `jax.random.key_data`. It is the one leaf whose
contents differ between the packages: restoring a checkpoint of the other
kind raises, naming the leaf (no silent reseed).

The JAX package gates every restore on the fftrans transition verifier
(`verify_restore_transition`, `analysis/transition.py`: ROADMAP A9, not
ported). Until it is, a restore here runs as JAX's does under
`--no-verify-plan`: the strict key and shape checks of `restore_tree` are
the gate, and `FFModel._transition` stays None.
"""

from __future__ import annotations

import numpy as np
import torch

from .checkpointer import (
    CheckpointCorruptError,
    _keystr,
    load_checkpoint,
    tree_items,
)

RNG_KEY = "['rng']"
RNG_KIND = "torch"

_WEIGHT_SECTIONS = ("params", "state", "opt_slots")


def _weight_of(executor, path: tuple):
    """(node, weight) a leaf of the weight sections belongs to, or None:
    its last two keys, where the executor has that weight."""
    if (executor is None or len(path) < 3
            or path[0] not in _WEIGHT_SECTIONS):
        return None
    owner, wname = path[-2], path[-1]
    node = executor._by_name.get(owner)
    if node is None or not any(ws.name == wname for ws in node.weight_specs):
        return None
    return owner, wname


def model_state_tree(ffmodel) -> dict:
    """The full training state persisted per checkpoint: the tensors the
    model holds (this rank's blocks on a mesh) and the generator's state.
    `state` may be None/{} (no stateful ops), normalized to {}."""
    return {
        "params": ffmodel._params,
        "state": ffmodel._state if ffmodel._state is not None else {},
        "opt_slots": ffmodel._opt_slots,
        "step": ffmodel._step,
        "counters": ffmodel._counters,
        "rng": ffmodel._rng.get_state(),
    }


def _map_leaves(fn, tree, path=()):
    if isinstance(tree, dict):
        return {k: _map_leaves(fn, v, path + (k,)) for k, v in tree.items()}
    return fn(path, tree)


def logical_state_tree(ffmodel) -> dict:
    """`model_state_tree` with every sharded weight leaf (a master, a
    slot, a state tensor split by the plan or sharded at rest) gathered
    into its whole tensor. On a mesh this is collective: every rank calls
    it at the same step, in its own thread, before any save is handed to a
    writer thread."""
    ex = ffmodel.executor

    def whole(path, leaf):
        w = _weight_of(ex, path)
        if w is None or not ex.spmd:
            return leaf
        return ex.full_weight(w[0], w[1], leaf)

    return _map_leaves(whole, model_state_tree(ffmodel))


def _as_tensor(saved) -> torch.Tensor:
    # np.array keeps a 0-d leaf 0-d (ascontiguousarray makes it 1-d)
    return saved if torch.is_tensor(saved) else torch.from_numpy(
        np.array(saved))


def restore_tree(template, flat_arrays: dict, prefix: str = "",
                 label: str = "checkpoint", executor=None):
    """Write saved flat arrays into `template`'s tensors, in place, and
    return `template`. With the model's `executor`, a weight leaf's saved
    whole array must have the weight's logical shape and each rank keeps
    its block under the restoring plan; other leaves must match their
    tensor's shape. Every key and shape is checked before any tensor is
    written: a missing leaf or a shape mismatch raises
    CheckpointCorruptError (a silently dropped leaf would train from stale
    values with no sign anything was lost)."""
    missing, writes = [], []
    for path, leaf in tree_items(template):
        key = prefix + _keystr(path)
        if key not in flat_arrays:
            missing.append(key)
            continue
        saved = flat_arrays[key]
        w = _weight_of(executor, path)
        want = (tuple(executor.weight_shape(*w)) if w is not None
                else tuple(leaf.shape))
        if tuple(saved.shape) != want:
            raise CheckpointCorruptError(
                f"{label}: leaf {key} has shape {tuple(saved.shape)} but the "
                f"compiled model expects {want} — architecture mismatch")
        writes.append((leaf, saved, w))
    if missing:
        raise CheckpointCorruptError(
            f"{label}: {len(missing)} leaves absent from checkpoint "
            f"(architecture mismatch?): {missing[:5]}")
    with torch.no_grad():
        for leaf, saved, w in writes:
            t = _as_tensor(saved)
            if w is not None:
                t = executor.local_weight(w[0], w[1], t)
            leaf.copy_(t.to(leaf.dtype))
    return template


def check_rng_kind(flat: dict, manifest: dict, label: str):
    """Refuse a generator state this package did not write."""
    kind = (manifest.get("extras") or {}).get("rng_kind", "jax")
    if kind != RNG_KIND:
        raise CheckpointCorruptError(
            f"{label}: leaf {RNG_KEY} holds a {kind!r} generator state "
            f"(written by the JAX package), which a torch.Generator cannot "
            f"take; restore the other sections with restore_tree")
    if RNG_KEY not in flat:
        raise CheckpointCorruptError(f"{label}: leaf {RNG_KEY} absent")


def restore_model(ffmodel, path: str) -> dict:
    """Restore a committed checkpoint dir into a *compiled* FFModel whose
    mesh and plan may differ from the saving run's, in place. Returns the
    manifest's extras dict (train-loop cursor, saving mesh...)."""
    if not ffmodel._compiled:
        raise RuntimeError("compile() before restoring a checkpoint")
    flat, manifest = load_checkpoint(path)
    check_rng_kind(flat, manifest, path)
    saved_state_keys = [k for k in flat if k.startswith("['state']")]
    template = model_state_tree(ffmodel)
    template.pop("rng")
    if not template["state"] and saved_state_keys:
        raise CheckpointCorruptError(
            f"{path}: checkpoint has op state {saved_state_keys[:3]} but the "
            "compiled model has none — architecture mismatch")
    rng = _as_tensor(flat[RNG_KEY])
    want = tuple(ffmodel._rng.get_state().shape)
    if tuple(rng.shape) != want:
        raise CheckpointCorruptError(
            f"{path}: leaf {RNG_KEY} has shape {tuple(rng.shape)} but this "
            f"model's {ffmodel._rng.device} generator state has {want}")
    restore_tree(template, flat, label=path, executor=ffmodel.executor)
    # a generator registered with a captured step: set_state writes the
    # state that step's next replay reads
    ffmodel._rng.set_state(rng.to(torch.uint8))
    return dict(manifest.get("extras") or {})
