"""Finding / AnalysisResult: the structured output of every ffcheck pass
(twin of `flexflow_tpu/analysis/findings.py`).

GSPMD (Xu et al. 2021, PAPERS.md "Analysis") frames sharding propagation
as a dataflow analysis whose result is checkable independently of the
executor; this module is the vocabulary those checks report in. A
`Finding` is one fact about a (PCG, Strategy, mesh) triple — an invariant
violation (severity "error": the plan must not launch), a hazard worth a
look ("warning"), or context ("info"). `AnalysisResult` aggregates the
findings of a pass pipeline run and serializes into the `analysis`
section of strategy_report.json, so run_doctor / CI can gate on it the
same way they gate on the makespan identity.

Finding codes are STABLE identifiers (tests and the ffcheck fuzzer key on
them); add new codes rather than renaming existing ones.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

SEV_ERROR = "error"
SEV_WARNING = "warning"
SEV_INFO = "info"
_SEVERITIES = (SEV_ERROR, SEV_WARNING, SEV_INFO)

# Stable finding codes, by pass. The plan-mutation fuzzer
# (tests/test_torch_analysis.py) injects one corruption per code and asserts
# ffcheck reports exactly that code.
#   sharding dataflow:   axis_reuse, indivisible_dim, unknown_axis,
#                        replica_dim, implicit_reshard, unknown_node,
#                        unknown_output, unknown_weight, rank_mismatch,
#                        overshard
#   memory liveness:     oom_predicted, memory_model_divergence,
#                        memory_timeline
#   collective checks:   bad_permutation, nondeterministic_bucket_order,
#                        coordinator_collective
#   donation/aliasing:   donated_reuse, donation_registry_mismatch
#   dtype flow (ffsan):  low_precision_accum, master_bypass,
#                        downcast_roundtrip, parallel_dtype_mismatch,
#                        numerics_clean
#   spmd uniformity:     host_divergent_branch, spmd_clean
#   transition (fftrans): dropped_state, unmapped_state,
#                        state_dtype_change, state_shape_change,
#                        missing_gather_path, kv_pool_mismatch,
#                        transition_oom, transition_memory_timeline,
#                        bad_transfer_permutation,
#                        nontopological_transfer_order,
#                        migration_donation_hazard,
#                        transfer_schedule_divergence, transition_clean
#   rule verify (ffrules): rule_shape_mismatch, rule_dtype_mismatch,
#                        rule_replica_dim_leak, rule_degree_violation,
#                        rule_partial_sum_nonlinear,
#                        rule_numeric_divergence, rule_matcher_unsound,
#                        rule_verification_crash,
#                        rule_registry_nondeterministic,
#                        rule_uninstantiable, rule_unassignable,
#                        rule_oracle_skipped, rules_clean,
#                        rules_fingerprint
#   lint (fflint rules): host_sync_in_loop, unsorted_dict_hash,
#                        global_rng, time_in_trace,
#                        unverified_transition, unverified_rule_load,
#                        raw_timer_in_hot_path, unnamed_op_scope


@dataclass
class Finding:
    """One static-analysis fact. `where` names the node/edge/file the
    finding anchors to; `details` is JSON-able context (bytes, specs,
    line numbers, timelines)."""

    severity: str
    code: str
    message: str
    pass_name: str = ""
    where: str = ""
    details: dict = field(default_factory=dict)

    def __post_init__(self):
        if self.severity not in _SEVERITIES:
            raise ValueError(
                f"severity must be one of {_SEVERITIES}, "
                f"got {self.severity!r}")

    def to_json(self) -> dict:
        out = {"severity": self.severity, "code": self.code,
               "pass": self.pass_name, "message": self.message}
        if self.where:
            out["where"] = self.where
        if self.details:
            out["details"] = self.details
        return out

    def __str__(self):
        loc = f" [{self.where}]" if self.where else ""
        return f"{self.severity.upper()} {self.code}{loc}: {self.message}"


class AnalysisResult:
    """Aggregated findings of one pass-pipeline run."""

    def __init__(self, findings: Optional[list[Finding]] = None,
                 passes_run: Optional[list[str]] = None):
        self.findings: list[Finding] = list(findings or [])
        self.passes_run: list[str] = list(passes_run or [])
        self.elapsed_s: float = 0.0

    def extend(self, findings, pass_name: str = ""):
        for f in findings:
            if pass_name and not f.pass_name:
                f.pass_name = pass_name
            self.findings.append(f)

    def errors(self) -> list[Finding]:
        return [f for f in self.findings if f.severity == SEV_ERROR]

    def warnings(self) -> list[Finding]:
        return [f for f in self.findings if f.severity == SEV_WARNING]

    def by_code(self, code: str) -> list[Finding]:
        return [f for f in self.findings if f.code == code]

    @property
    def ok(self) -> bool:
        return not self.errors()

    def summary(self) -> dict:
        return {
            "errors": len(self.errors()),
            "warnings": len(self.warnings()),
            "info": len([f for f in self.findings
                         if f.severity == SEV_INFO]),
            "passes_run": list(self.passes_run),
        }

    def to_json(self) -> dict:
        out = self.summary()
        out["elapsed_s"] = self.elapsed_s
        out["findings"] = [f.to_json() for f in self.findings]
        return out

    def render(self, max_findings: int = 50) -> str:
        """Human-readable rendering (ffcheck's console output)."""
        s = self.summary()
        lines = [f"ffcheck: {s['errors']} error(s), {s['warnings']} "
                 f"warning(s), {s['info']} info "
                 f"({', '.join(self.passes_run) or 'no passes'})"]
        ranked = sorted(
            self.findings,
            key=lambda f: _SEVERITIES.index(f.severity))
        for f in ranked[:max_findings]:
            lines.append(f"  {f}")
        if len(ranked) > max_findings:
            lines.append(f"  ... {len(ranked) - max_findings} more")
        return "\n".join(lines)


class PlanVerificationError(ValueError):
    """Raised by the compile gate when a pass reports errors and
    --no-verify-plan was not passed. Carries the full result so callers
    (the warm-start miss path, tests) can inspect the findings."""

    def __init__(self, result: AnalysisResult):
        self.result = result
        errs = result.errors()
        head = "; ".join(str(f) for f in errs[:5])
        more = f" (+{len(errs) - 5} more)" if len(errs) > 5 else ""
        super().__init__(
            f"plan verification failed with {len(errs)} error(s): "
            f"{head}{more} — pass --no-verify-plan to launch anyway")
