"""Source-level sub-checks of the ffcheck pipeline (twin of
`flexflow_tpu/analysis/sources.py`).

Passes 3, 4 and 6 include checks that live in HOST code, not the PCG:
coordinator-gated collectives (the multi-rank deadlock idiom), a held
tensor of a captured step read stale after its replay, and host-divergent
branches. All are AST rules (analysis/lint.py); this module scopes them
to the port's runtime modules that call collectives or captured steps,
and caches the scan per process so the compile gate parses the files
once, not once per compile.
"""

from __future__ import annotations

import dataclasses
import os

from .findings import Finding
from .lint import lint_file

# The modules whose host code touches collectives or captured step
# executables: the blast radius of the source-level hazards.
RUNTIME_MODULES = (
    "model.py",
    "executor.py",
    "distributed.py",
    "engine/pipelined.py",
    "serving/engine.py",
    "resilience/manager.py",
    "resilience/checkpointer.py",
    "warmstart/manager.py",
    "diagnostics/drift.py",
)

# the source-level rules the pass pipeline consumes, scanned together in
# ONE pass over the module set (pass 3 takes coordinator_collective,
# pass 4 donated_reuse, pass 6 host_divergent_branch)
_SOURCE_RULES = ("coordinator_collective", "donated_reuse",
                 "host_divergent_branch")

_cache: list | None = None


def package_root() -> str:
    """The port's package directory (`flexflow_tpu_torch/`)."""
    return os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _scan() -> list[Finding]:
    global _cache
    if _cache is None:
        root = package_root()
        findings: list[Finding] = []
        for rel in RUNTIME_MODULES:
            path = os.path.join(root, rel)
            if os.path.exists(path):
                findings.extend(lint_file(path, select=_SOURCE_RULES))
        _cache = findings
    return _cache


def runtime_findings(rules: tuple[str, ...]) -> list[Finding]:
    """Findings of the source-level rules over the runtime modules,
    filtered to `rules`, with pass_name cleared so the consuming pass
    attributes them to itself. The scan runs once per process."""
    want = set(rules)
    return [dataclasses.replace(f, pass_name="")
            for f in _scan() if f.code in want]


def scan_problems() -> list[Finding]:
    """An unparseable runtime module, downgraded to WARNING: its checks
    did not run, which must be visible, but a verifier-side failure must
    never abort every compile. Reported once, by pass 3."""
    return [dataclasses.replace(f, severity="warning", pass_name="")
            for f in _scan() if f.code == "parse_error"]
