"""In-process live-state migration between two compiled plans (twin of
`flexflow_tpu/resilience/migrate.py`).

The apply half of fftrans (analysis/transition.py): `migrate_state(old,
new)` moves a compiled FFModel's FULL training state (params, fp32
masters, optimizer slots, step, metric counters, the generator's state,
serving KV state) onto a second compiled model of the same logical PCG
whose Strategy, mesh factorization, ranks and/or ZeRO update stage
differ, WITHOUT a checkpoint-restart round trip (Gemini, SOSP '23). The
transition is first built and VERIFIED statically (`gate_transition`:
state-mapping completeness, dtype/shape preservation, gather paths,
transition-time memory, ring bijectivity, schedule uniformity); only a
verified plan touches live state, and --no-verify-plan downgrades to
warnings exactly like the compile gate.

The transfers run device to device over the meshes' own process groups
(NCCL on the card, gloo on the CPU), in the plan's order: each leaf is
gathered whole over the old mesh's groups (`Executor.full_weight`, the
plan's all_gathers; a replicated leaf moves no byte), sent from the
planning rank to the ranks the new mesh adds (a broadcast over the new
mesh, only when it grows past the old one), and sliced into this rank's
block of the new placement (`Executor.local_weight`, the plan's local
slices), written in place into the tensors the new model holds: the
buffers its executor's steps will capture. There is no host route: a
leaf that cannot move raises `MigrationError` naming it. Values move
bit-exactly (a dtype change is a verification ERROR, never a cast), so a
migrated run's trajectory is bit-identical to a checkpoint-restart of
the same state.

Ranks: every rank of either mesh takes part (a rank parked by a shrink
gathers its old blocks and keeps nothing; a rank a grow brings back
receives). The planning rank is the lowest rank of both meshes; where
some taking part is not a member of both, it plans and gates alone and
shares the plan (and a refusal) with the others, so every rank runs one
program. `donate=True` frees each source tensor once its transfer has
landed, the schedule fftrans's `transition_memory` pass accounts for.

The executed plan (with measured seconds next to the prediction, the
fidelity datapoint of the elastic payoff rule) lands on
`new._transition`, and strategy_report.json gains a `transition` section
whose predicted_s reproduces from the JSON alone
(`transition.verify_transition_total`)."""

from __future__ import annotations

import time

import torch


class MigrationError(RuntimeError):
    """A leaf that could not move between two plans, named."""


def migrate_state(old, new, *, plan=None, donate: bool = False) -> dict:
    """Migrate `old`'s live training state onto `new` in-process.

    Both models must be compiled over the same logical PCG (same layer
    names/shapes); Strategy, mesh factorization, ranks and update stage
    may all differ. Builds + verifies the TransitionPlan (raises
    PlanVerificationError naming the leaf and finding class on an
    unverifiable mapping unless --no-verify-plan), executes it, and
    returns the plan JSON with `measured_s` filled in (empty on a rank of
    neither mesh). Collective over the ranks of both meshes.
    """
    from .. import telemetry

    assert getattr(old, "_compiled", False), "compile() old before migrating"
    assert getattr(new, "_compiled", False), "compile() new before migrating"

    # the destination model's telemetry session becomes the sink for the
    # migration's spans/events, exactly as compile/fit scope theirs
    session = getattr(new, "_telemetry", None)
    if session is not None:
        telemetry.activate(session)
    try:
        return _migrate_impl(old, new, plan=plan, donate=donate)
    finally:
        if session is not None:
            telemetry.deactivate(session)


def _plan_json(old, new, plan, share: bool, planner: int, me: int,
               ranks: list) -> dict:
    """The gated plan's JSON on every rank taking part: built and gated
    here, or (sharing) on the planner alone and sent to the others."""
    from .. import telemetry
    from ..analysis import transition as fftrans
    from ..distributed import share_object

    err, plan_json = None, None
    if not share or me == planner:
        if plan is None:
            plan = fftrans.plan_model_transition(old, new)
        try:
            with telemetry.span("migrate.verify"):
                result = fftrans.gate_transition(plan, new.config,
                                                 label="migrate_state")
            plan_json = plan.to_json(analysis=result)
        except Exception as e:
            if not share:
                raise
            err = e
    if share:
        box = share_object(
            {"plan": plan_json,
             "error": None if err is None
             else f"{type(err).__name__}: {err}"}
            if me == planner else None, planner, ranks, old.mesh, new.mesh)
        if err is not None:
            raise err
        if box["error"] is not None:
            raise MigrationError(
                f"migrate_state: rank {planner} refused the transition: "
                f"{box['error']}")
        plan_json = box["plan"]
    return plan_json


def _migrate_impl(old, new, *, plan, donate: bool) -> dict:
    from .. import telemetry
    from ..distributed import world_rank, world_size
    from .checkpointer import _keystr, tree_items
    from .manager import _rewrite_report
    from .reshard import _weight_of, model_state_tree

    world, me = world_size(), world_rank()
    old_ranks, new_ranks = list(old.mesh.ranks), list(new.mesh.ranks)
    in_old = world <= 1 or old.mesh.member
    in_new = world <= 1 or new.mesh.member
    ranks = sorted(set(old_ranks) | set(new_ranks)) if world > 1 else [0]
    if not (in_old or in_new):
        return {}  # parked on both sides: nothing to move or keep
    both = sorted(set(old_ranks) & set(new_ranks))
    if world > 1 and not both:
        raise MigrationError(
            f"migrate_state: no rank holds both plans (old ranks "
            f"{old_ranks}, new ranks {new_ranks}): nothing can plan the "
            f"transfers")
    planner = both[0] if world > 1 else 0
    share = world > 1 and set(old_ranks) != set(new_ranks)
    plan_json = _plan_json(old, new, plan, share, planner, me, ranks)

    src_flat = ({_keystr(p): (p, leaf)
                 for p, leaf in tree_items(model_state_tree(old))}
                if in_old else {})
    dst_flat = ({_keystr(p): (p, leaf)
                 for p, leaf in tree_items(model_state_tree(new))}
                if in_new else {})
    # a grow sends every leaf from the planner to the ranks it adds, over
    # the new mesh's group of all its devices
    grow = world > 1 and bool(set(new_ranks) - set(old_ranks))
    send = new.mesh.all_group() if grow and in_new else None
    dev = new.device if in_new else old.device
    if send is not None:
        # its communicator opens at its first collective, here, apart
        # from the transfers the measurement times
        send.open(dev)

    t0 = time.perf_counter()
    moved = 0
    with telemetry.span("migrate.apply"), torch.no_grad():
        for t in sorted(plan_json["transfers"], key=lambda t: t["order"]):
            key = t["key"]
            try:
                moved += _move_leaf(
                    t, src_flat.get(key), dst_flat.get(key),
                    old.executor if in_old else None,
                    new.executor if in_new else None, new if in_new
                    else None, send, planner, dev, donate, _weight_of)
            except MigrationError:
                raise
            except Exception as e:
                raise MigrationError(
                    f"migrate_state: leaf {key} could not move from the "
                    f"old plan to the new: {type(e).__name__}: {e}") from e
        if dev.type == "cuda":
            # one drain at the end: the measurement IS the migration's
            # wall time, not a hot loop
            torch.cuda.synchronize(dev)
    measured_s = time.perf_counter() - t0
    if donate and in_old:
        old._compiled = False  # the old model's state buffers are dead
    plan_json["measured_s"] = measured_s
    plan_json["moved_bytes"] = moved
    if not in_new:
        return plan_json
    predicted = float(plan_json.get("predicted_s") or 0.0)
    if predicted > 0 and measured_s > 0:
        # the elastic payoff rule's fidelity datapoint: this migration's
        # measured/predicted ratio, folded into the device kind's entry
        # of the warm-start calibration DB (elastic/payoff.py)
        from ..elastic.payoff import record_fidelity

        record_fidelity(new, measured_s / predicted)
    new._transition = plan_json
    telemetry.inc("migrations_total")
    telemetry.observe("migration_s", measured_s)
    telemetry.event(
        "migrate", predicted_s=predicted, measured_s=measured_s,
        transfers=len(plan_json["transfers"]),
        bytes_on_wire=sum(plan_json["bytes_on_wire"].values()),
        moved_bytes=moved,
        errors=int((plan_json.get("analysis") or {}).get("errors", 0)))
    _rewrite_report(new)
    return plan_json


def _move_leaf(t, src, dst, old_ex, new_ex, new, send, planner, dev,
               donate, weight_of) -> int:
    """One transfer of the plan: gather on the old mesh, send to the
    ranks a grow adds, slice and write on the new one. Returns the bytes
    this rank received."""
    import torch.distributed as dist

    received = 0
    full = None
    if src is not None:
        path, leaf = src
        w = weight_of(old_ex, path, leaf)
        full = old_ex.full_weight(*w, leaf) if w is not None else leaf
        if full is not leaf:
            received += (full.numel() - leaf.numel()) * full.element_size()
    if send is not None:
        if full is None:
            full = torch.empty(tuple(t["shape"]),
                               dtype=getattr(torch, t["dtype"]), device=dev)
            received += full.numel() * full.element_size()
        cpu = full.device.type == "cpu" and dev.type == "cuda"
        buf = full.to(dev) if cpu else full
        dist.broadcast(buf, src=planner, group=send.pg)
        full = buf.cpu() if cpu else buf
    if dst is not None:
        if full is None:
            # only reachable under --no-verify-plan (unmapped_state was
            # downgraded): the new model keeps its fresh leaf
            return received
        path, leaf = dst
        if path == ("rng",):
            new._rng.set_state(full.cpu().to(torch.uint8))
        else:
            w = weight_of(new_ex, path, leaf)
            block = new_ex.local_weight(*w, full) if w is not None else full
            leaf.copy_(block)
    if donate and src is not None and src[0] != ("rng",):
        # the source is dead once its transfer is queued: later
        # allocations on the stream reuse its memory after the copy
        src[1].untyped_storage().resize_(0)
    return received
