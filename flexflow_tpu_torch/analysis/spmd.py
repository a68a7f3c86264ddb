"""Pass 6 — cross-rank SPMD divergence detector (the SPMD half of ffsan;
twin of `flexflow_tpu/analysis/spmd.py`).

The port's mesh is correct only while every rank builds and captures the
SAME step against the SAME plan. Two halves:

1. **Static**: the `host_divergent_branch` lint rule (analysis/lint.py)
   over the runtime modules — an `if` whose test calls a per-host
   nondeterministic source (time, RNG, environment, hostname) guarding a
   collective (deadlock: some ranks never arrive) or a capture entry
   (divergent CUDA graphs).
2. **Runtime** (opt-in, `--spmd-barrier`): `fingerprint_barrier` — before
   the first step, every rank hashes the ingredients of its step (plan
   fingerprint and strategy, held positions, update-spec layout, mesh
   axes, numerics policy; where the JAX package hashes its JAX version
   and its donation probe, the port hashes the torch and CUDA versions,
   the card's name and capability and the `csrc/` sources its kernels
   were built from) and compares with the coordinator's over
   `distributed.broadcast_json`. A mismatch raises `SPMDDivergenceError`
   on every rank in lockstep: a structured abort at step 0 instead of a
   hang or a silently different program. Costs one small broadcast and
   one gather; nothing when off.
"""

from __future__ import annotations

import hashlib
import json
import os

from .findings import Finding, SEV_INFO
from .sources import package_root, runtime_findings

PASS_NAME = "spmd_uniformity"


class SPMDDivergenceError(RuntimeError):
    """Raised by the fingerprint barrier when the ranks' step
    fingerprints disagree. Carries both payloads so the first diverging
    component is printable; `peer_mismatch` marks the ranks whose OWN
    fingerprint matched the coordinator's but which must still abort
    because a peer diverged (the lockstep half of the barrier)."""

    def __init__(self, local: dict, remote: dict,
                 peer_mismatch: bool = False):
        self.local = local
        self.remote = remote
        self.peer_mismatch = peer_mismatch
        if peer_mismatch:
            msg = ("SPMD fingerprint mismatch before the first step — "
                   "this rank matches the coordinator, but a peer rank "
                   "reported a divergent step fingerprint; aborting in "
                   "lockstep with it.")
        else:
            diverged = sorted(
                k for k in set(local) | set(remote)
                if local.get(k) != remote.get(k))
            msg = (
                "SPMD fingerprint mismatch before the first step — "
                "this rank would run a different program than the "
                f"coordinator. Diverging component(s): {diverged}. "
                "Typical causes: per-host control flow on time/RNG/env "
                "(fflint host_divergent_branch), a plan adopted on one "
                "rank only, or kernels built from different sources or "
                "for different cards.")
        super().__init__(msg)


def run(graph, mesh, ctx=None) -> list[Finding]:
    """Static half: host-divergent branches in the runtime host code
    (the source scan is cached per process with the pass-3/4 rules)."""
    findings = list(runtime_findings(("host_divergent_branch",)))
    if not findings:
        findings.append(Finding(
            SEV_INFO, "spmd_clean",
            "no host-divergent branches feeding collectives or captured "
            "code in the runtime modules"))
    return findings


# --------------------------------------------------------------- runtime

_kernel_digest: str | None = None


def kernel_sources_digest() -> str:
    """Digest of the `csrc/` sources the kernels are built from (once a
    process: the sources do not change under a run)."""
    global _kernel_digest
    if _kernel_digest is None:
        h = hashlib.sha256()
        root = os.path.join(package_root(), "csrc")
        for name in sorted(os.listdir(root)) if os.path.isdir(root) else ():
            with open(os.path.join(root, name), "rb") as f:
                h.update(name.encode())
                h.update(f.read())
        _kernel_digest = h.hexdigest()[:16]
    return _kernel_digest


def _card(device) -> dict:
    import torch

    device = torch.device(device)
    if device.type != "cuda":
        return {"type": device.type}
    idx = device.index if device.index is not None else \
        torch.cuda.current_device()
    return {"type": "cuda", "name": torch.cuda.get_device_name(idx),
            "capability": list(torch.cuda.get_device_capability(idx))}


def graph_digest(graph) -> str:
    """A digest of the graph's structure (op types, params and wiring in
    topological order) that every process computes alike. The JAX
    package hashes `Graph.hash()`, which folds Python's `hash` of strings,
    randomized per process, so two processes of one plan disagree on it
    (ROADMAP queue C, reference-side)."""
    index = {n.guid: i for i, n in enumerate(graph.topo_order())}
    canon = [[n.op_type.name, repr(n.params), sorted(
        (index[e.src], e.src_idx, e.dst_idx)
        for e in graph.in_edges[n.guid])] for n in graph.topo_order()]
    return hashlib.sha256(json.dumps(canon).encode()).hexdigest()[:16]


def fingerprint_payload(model) -> dict:
    """The per-rank ingredients of the step, as a dict of stable digests.
    Everything here must be identical across ranks for the mesh's steps
    to stay in lockstep; anything legitimately rank-local (the rank, the
    device index) stays OUT."""
    import torch

    from ..parallel.strategies import Strategy
    from .lint import DONATED_CALLEES

    def digest(obj) -> str:
        return hashlib.sha256(
            json.dumps(obj, sort_keys=True, default=str).encode()
        ).hexdigest()[:16]

    executor = model.executor
    update_specs = dict(executor.update_specs) if executor else {}
    cfg = model.config
    return {
        "graph": graph_digest(model.graph),
        "plan_fingerprint": str(model._plan_fingerprint),
        "strategy": digest(Strategy(model._strategy or {}).to_json()),
        "mesh_axes": digest({k: int(v)
                             for k, v in dict(model.mesh.shape).items()}),
        # the held positions a captured step rewrites in place
        "donation": digest({k: list(v)
                            for k, v in DONATED_CALLEES.items()}),
        "runtime": digest({"torch": torch.__version__,
                           "cuda": torch.version.cuda,
                           "card": _card(model.device)}),
        "kernels": kernel_sources_digest(),
        "update_specs": digest(sorted(
            (f"{n}/{w}", str(spec), list(shape))
            for (n, w), (spec, shape) in update_specs.items())),
        "numerics": digest({
            "computation_dtype": str(cfg.computation_dtype),
            "allow_tensor_op_math": bool(
                cfg.allow_tensor_op_math_conversion),
            "sanitize_numerics": bool(
                getattr(cfg, "sanitize_numerics", False)),
            "loss_type": str(model.loss_type),
            "opt_slots": (model.optimizer.num_slots
                          if model.optimizer is not None else 0)}),
    }


def step_fingerprint(model) -> str:
    """One digest over the full payload (the value logged/recorded)."""
    return hashlib.sha256(
        json.dumps(fingerprint_payload(model), sort_keys=True).encode()
    ).hexdigest()[:16]


def _gather_match_flags(match: bool) -> list:
    """Every rank's match flag, gathered on every rank, so each learns
    whether ANY peer diverged: the raise must reach the whole mesh, or
    the surviving ranks hang in the next collective."""
    from ..distributed import gather_json

    return [bool(r.get("match")) for r in gather_json({"match": match})]


def fingerprint_barrier(model, broadcast=None, gather=None) -> dict:
    """Cross-rank uniformity barrier, two phases: (1) the coordinator
    broadcasts its fingerprint payload and every rank compares; (2) the
    per-rank match flags are gathered so a mismatch raises
    SPMDDivergenceError on EVERY rank in lockstep. Returns the verdict
    record ({status, fingerprint}) that the compile record and the
    strategy report carry.

    `broadcast` / `gather` default to the port's channels
    (`distributed.broadcast_json`, `gather_json`) and are injectable so a
    divergence can be simulated in one process. A run of one process with
    the default channels short-circuits to status "single_process"."""
    from ..distributed import broadcast_json, is_coordinator, process_count

    payload = fingerprint_payload(model)
    fp = step_fingerprint(model)
    if broadcast is None and gather is None and process_count() <= 1:
        return {"status": "single_process", "fingerprint": fp}
    broadcast = broadcast or broadcast_json
    remote = broadcast(
        {"payload": payload, "fingerprint": fp}
        if is_coordinator() else None)
    match = remote.get("fingerprint") == fp
    flags = (gather or _gather_match_flags)(match)
    if not all(flags):
        if not match:
            raise SPMDDivergenceError(payload,
                                      remote.get("payload") or {})
        raise SPMDDivergenceError(payload, payload, peer_mismatch=True)
    return {"status": "ok", "fingerprint": fp}
