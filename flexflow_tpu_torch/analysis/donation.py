"""Pass 4 — donation/aliasing checker (twin of
`flexflow_tpu/analysis/donation.py`), re-aimed at how the port donates.

The JAX package donates its step executables' carried state: the input
buffer is dead after the call. The port donates by updating in place: a
captured step (`executor.CapturedStep`) holds its tensors at fixed
positions (`held=` of `Executor._compiled`) and every replay rewrites
them. The hazard that follows is an alias: a name bound to a held tensor
(or a part of it) before the call and read after it as the value from
before the call reads the new value instead. Two checks:

1. **Stale alias after a replay** (lint rule `donated_reuse`): at every
   call site of a known captured step, an alias of an argument at a held
   position, taken before the call without a copy, must not be read
   after it. Scanned over the runtime modules (fit's step loop, the
   chunked engine's dispatch, the serving engine's decode step).

2. **Registry cross-check**: the analysis's own table of held positions
   (`lint.DONATED_CALLEES`) is verified against `executor.py`'s AST — the
   `held=(...)` tuple each `build_*` method passes to `self._compiled`.
   The checker re-derives the contract from the source instead of
   trusting its own table; if the executor changes a held position and
   the table lags, the pass fails loudly instead of scanning with stale
   positions (`donation_registry_mismatch`).
"""

from __future__ import annotations

import ast
import os

from .findings import Finding, SEV_ERROR, SEV_INFO
from .lint import DONATED_CALLEES
from .sources import package_root, runtime_findings

PASS_NAME = "donation_aliasing"

# executor build method -> the call-site names its captured step binds to
BUILDER_CALLEES = {
    "build_train_step": ("step_fn", "_train_step"),
    "build_chunked_train_step": ("chunk_fn",),
    "build_eval_step": ("eval_fn", "_eval_step"),
    "build_decode_step": ("_step_fn", "_decode_step"),
}

_CAPTURE_CALLS = ("_compiled", "CapturedStep")


def executor_donation_table(executor_path: str = "") -> dict:
    """{build method name: held positions tuple} extracted from
    executor.py's AST — the ground truth the registry is checked
    against."""
    path = executor_path or os.path.join(package_root(), "executor.py")
    with open(path, encoding="utf-8") as f:
        tree = ast.parse(f.read())
    out: dict[str, tuple] = {}
    for node in ast.walk(tree):
        if not isinstance(node, ast.FunctionDef) or \
                not node.name.startswith("build_"):
            continue
        for call in ast.walk(node):
            if not isinstance(call, ast.Call):
                continue
            func = call.func
            name = (func.attr if isinstance(func, ast.Attribute)
                    else getattr(func, "id", ""))
            if name not in _CAPTURE_CALLS:
                continue
            for kw in call.keywords:
                if kw.arg != "held" or not isinstance(kw.value, ast.Tuple):
                    continue
                try:
                    out[node.name] = tuple(ast.literal_eval(kw.value))
                except (ValueError, SyntaxError):
                    continue
    return out


_registry_cache: dict = {}


def registry_problems(executor_path: str = "") -> list[Finding]:
    """Cross-check DONATED_CALLEES against the executor source. Cached
    per path for the life of the process (the source cannot change under
    a running compile)."""
    hit = _registry_cache.get(executor_path)
    if hit is not None:
        return list(hit)
    findings = _registry_problems_uncached(executor_path)
    _registry_cache[executor_path] = list(findings)
    return findings


def _registry_problems_uncached(executor_path: str = "") -> list[Finding]:
    findings: list[Finding] = []
    try:
        table = executor_donation_table(executor_path)
    except (OSError, SyntaxError) as e:
        return [Finding(
            SEV_ERROR, "donation_registry_mismatch",
            f"could not read the executor's held positions: {e}",
            pass_name=PASS_NAME)]
    for builder, callees in BUILDER_CALLEES.items():
        actual = table.get(builder)
        if actual is None:
            findings.append(Finding(
                SEV_ERROR, "donation_registry_mismatch",
                f"executor has no held= declaration for {builder}() — "
                f"the registry expects one",
                where=f"executor.py:{builder}"))
            continue
        for callee in callees:
            expected = DONATED_CALLEES.get(callee)
            if expected != actual:
                findings.append(Finding(
                    SEV_ERROR, "donation_registry_mismatch",
                    f"registry says {callee}() holds {expected}, "
                    f"executor.{builder}() declares {actual} — the "
                    f"stale-alias scan would run with stale positions",
                    where=f"executor.py:{builder}",
                    details={"registry": list(expected or ()),
                             "executor": list(actual)}))
    for builder in table:
        if builder not in BUILDER_CALLEES:
            findings.append(Finding(
                SEV_ERROR, "donation_registry_mismatch",
                f"executor.{builder}() captures a step with held tensors "
                f"but the registry has no call-site names for it — its "
                f"call sites are unscanned",
                where=f"executor.py:{builder}"))
    return findings


def run(graph, mesh, ctx=None) -> list[Finding]:
    findings = registry_problems()
    findings.extend(runtime_findings(("donated_reuse",)))
    if not findings:
        findings.append(Finding(
            SEV_INFO, "donation_clean",
            f"{len(BUILDER_CALLEES)} captured steps: registry matches the "
            f"executor's held positions, no stale alias of a held "
            f"tensor read after a replay"))
    return findings
