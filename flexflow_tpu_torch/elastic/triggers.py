"""Trigger streams for the elastic controller (twin of
`flexflow_tpu/elastic/triggers.py`).

Two triggers feed `ElasticController.maybe_replan`:

- **drift** — sustained cost-model drift. The DriftMonitor already owns
  the hysteresis (advisory once per excursion, re-arm at threshold/2);
  the DiagnosticsManager forwards each advisory here instead of firing
  its own recompile hook, so one excursion produces ONE trigger.
- **capacity** — a delta between the visible device set and the compiled
  mesh (cards withdrawn, or restored). `CapacityWatcher` reads the
  visible set (injectable for tests) every `check_every` controller calls
  and proposes a new mesh factorization by rescaling the data axis; a
  visible count the fixed model/pipe/seq axes cannot divide, or one past
  the `torchrun` world (a process group cannot grow), is reported with
  `new_axes=None` so the controller records a declined decision instead
  of compiling an impossible mesh.

The port's devices are the ranks of the `torch.distributed` world, each
its own process. The visible set is the set of world ranks still offered
(by default all of them: a lone card sees 1), and on a world of more than
one rank the controller agrees the count at every check
(`CapacityView`: one MAX all-reduce of the negated counts and membership
over the whole world, so the MIN wins), parked ranks included: no rank
decides a re-plan that another does not. The agreement rides the step
edge's all-reduce (`resilience.PreemptionHandler.poll`) when `fit`
drives the controller.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Optional, Sequence


@dataclass
class CapacityDelta:
    """One observed visible-vs-compiled device-set delta."""

    step: int
    visible: int            # devices visible now
    compiled: int           # devices in the compiled mesh
    new_axes: Optional[tuple]  # proposed mesh_axis_sizes (None: refused)
    shrink: bool            # visible < compiled → forced migration
    # the world ranks the proposed mesh takes (None: the first `visible`),
    # and why `new_axes` is None
    ranks: Optional[tuple] = None
    reason: str = ""

    def to_record(self) -> dict:
        return {
            "step": int(self.step), "visible": int(self.visible),
            "compiled": int(self.compiled),
            "new_axes": (list(self.new_axes)
                         if self.new_axes is not None else None),
            "shrink": bool(self.shrink),
        }


@dataclass
class CapacityView:
    """One rank's (or, agreed, the world's) view of the visible set: the
    count, the world ranks among it, the active ranks' step and cooldown
    anchor (parked ranks send -1), and whether the active ranks left fit
    (`released`: the parked ranks leave with them)."""

    count: int
    ranks: tuple = field(default_factory=tuple)
    step: int = -1
    anchor: int = -1
    released: bool = False

    def encode(self, world: int) -> list:
        """Ints whose MAX over the ranks is the agreed view: the count
        and membership negated (their MIN), the rest as they are."""
        mine = set(self.ranks)
        return ([1 if self.released else 0, int(self.step),
                 int(self.anchor), -int(self.count)]
                + [-1 if r in mine else 0 for r in range(world)])

    @staticmethod
    def decode(vals: Sequence[int], world: int) -> "CapacityView":
        return CapacityView(
            count=-int(vals[3]),
            ranks=tuple(r for r in range(world) if vals[4 + r] < 0),
            step=int(vals[1]), anchor=int(vals[2]),
            released=bool(vals[0]))


def offered_ranks() -> list:
    """The default visible set: every rank of the world (no scheduler
    withdraws a card from a torchrun world by itself)."""
    from ..distributed import world_size

    return list(range(world_size()))


class CapacityWatcher:
    """Detects grow/shrink of the visible device set vs the compiled
    mesh. Stateless between checks except the poll cadence — the
    controller's cooldown owns anti-flap pacing for grows (a shrink is
    forced: the compiled mesh no longer physically exists)."""

    def __init__(self, model,
                 visible_devices_fn: Optional[Callable[[], Sequence]] = None,
                 check_every: int = 8):
        self.model = model
        self._visible_fn = visible_devices_fn or offered_ranks
        self.check_every = max(1, int(check_every))
        self._calls = 0

    def propose_axes(self, visible: int) -> Optional[tuple]:
        """mesh_axis_sizes for `visible` devices: rescale the data axis,
        keep every other axis fixed. None when the fixed axes don't
        divide the visible count, when it is past the torchrun world, or
        when the mesh is multi-host (capacity moves are one host's
        scope, like serving)."""
        return self._propose(visible)[0]

    def _propose(self, visible: int) -> tuple:
        from ..distributed import world_size
        from ..machine import AXIS_DATA

        cfg = self.model.config
        if getattr(cfg, "num_nodes", 1) > 1:
            return None, "multi-host mesh"
        if visible > world_size():
            return None, (f"{visible} devices are past the torchrun world "
                          f"of {world_size()} ranks")
        ms = cfg.mesh_shape()
        # the COMPILED mesh's sizes, in the config's axis order (a
        # mesh-shape search may have replaced the configured sizes)
        compiled = dict(self.model.mesh.shape)
        sizes = [int(compiled.get(a, s))
                 for a, s in zip(ms.axis_names, ms.axis_sizes)]
        if AXIS_DATA not in ms.axis_names:
            return None, "no data axis"
        di = ms.axis_names.index(AXIS_DATA)
        fixed = 1
        for i, s in enumerate(sizes):
            if i != di:
                fixed *= s
        if visible < fixed or visible % fixed:
            return None, "no mesh factorization for visible device set"
        sizes[di] = visible // fixed
        return tuple(sizes), ""

    def due(self) -> bool:
        """Advance the cadence: True on every check_every-th call."""
        self._calls += 1
        return (self._calls - 1) % self.check_every == 0

    def view(self) -> CapacityView:
        """This rank's view of the visible set. A visible-set function
        that raises sees the compiled mesh: the rank still joins the
        agreement, and asks for no move."""
        from ..distributed import world_size

        world = world_size()
        try:
            vis = list(self._visible_fn())
        except Exception:
            mesh = self.model.mesh
            return CapacityView(count=int(mesh.devices.size),
                                ranks=tuple(mesh.ranks))
        if all(isinstance(v, int) for v in vis):
            ranks = tuple(sorted({v for v in vis if 0 <= v < world}))
        else:  # device handles: the first ranks of the world
            ranks = tuple(range(min(len(vis), world)))
        return CapacityView(count=len(vis), ranks=ranks)

    def delta(self, step: int, view: Optional[CapacityView]
              ) -> Optional[CapacityDelta]:
        """The CapacityDelta of an agreed view, or None when the visible
        count matches the compiled mesh."""
        if view is None:
            return None
        visible = int(view.count)
        compiled = int(self.model.mesh.devices.size)
        if visible == compiled:
            return None
        axes, reason = self._propose(visible)
        ranks = None
        if axes is not None:
            if len(view.ranks) < visible:
                axes, reason = None, (
                    f"{visible} devices visible but only ranks "
                    f"{list(view.ranks)} of the world are offered")
            else:
                ranks = tuple(view.ranks[:visible])
        return CapacityDelta(
            step=int(step), visible=visible, compiled=compiled,
            new_axes=axes, shrink=visible < compiled, ranks=ranks,
            reason=reason)

    def check(self, step: int) -> Optional[CapacityDelta]:
        """Poll the visible device set (every check_every-th call);
        returns a CapacityDelta when it no longer matches the compiled
        mesh. This process's own view: the elastic controller agrees it
        over the ranks first (a serving engine decides alone)."""
        if not self.due():
            return None
        return self.delta(step, self.view())
