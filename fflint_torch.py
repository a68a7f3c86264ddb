"""fflint for the PyTorch port: the repo-wide hazard lint
(`flexflow_tpu_torch/analysis/lint.py` rules), twin of `scripts/fflint.py`.

Rules — each aims the JAX package's bug class at the port's form of it:

  host_sync_in_loop        .item()/.tolist()/.cpu()/torch.cuda.synchronize()
                           inside a for/while loop, not behind a
                           telemetry/diagnostics gate
  unsorted_dict_hash       dict iteration feeding a fingerprint/hash
                           without sorted(...)
  global_rng               process-global np.random.* / random.* /
                           torch.manual_seed calls
  time_in_trace            time.*/RNG calls inside a function captured
                           into a CUDA graph
  coordinator_collective   a collective inside an is_coordinator() /
                           rank == 0 branch
  donated_reuse            an alias of a captured step's held tensor
                           read after the call rewrote it in place
  low_precision_accum      a summing reduction over a bf16/fp16 cast
  host_divergent_branch    per-host-nondeterministic branch (time/RNG/
                           env/hostname) guarding a collective or a
                           capture entry
  unverified_transition    a state re-placement applier in a function
                           that never consults the fftrans checker
  unverified_rule_load     a GraphXfer construct/load call in a function
                           that never consults the ffrules verifier
  raw_timer_in_hot_path    bare perf_counter reads in a step/decode/
                           prefill function outside telemetry/
  unnamed_op_scope         an op dispatch outside an attribution range

Suppression: trailing `# fflint: ok [codes]` on the line or its `def`.

Usage: python fflint_torch.py [paths...] [--select r1,r2]
Default paths: flexflow_tpu_torch/, every root `*_torch.py`,
chip_smoke.py and kernel_sweep.py (tests are exempt — they synthesize
hazards on purpose). Exits 1 on ANY finding, 2 on an unknown rule.
"""

import glob
import os
import sys

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)


def default_paths() -> list:
    """The port's tree: the package, the root scripts that drive it, and
    the card's smoke and sweep."""
    return ([os.path.join(ROOT, "flexflow_tpu_torch")]
            + sorted(glob.glob(os.path.join(ROOT, "*_torch.py")))
            + [os.path.join(ROOT, "chip_smoke.py"),
               os.path.join(ROOT, "kernel_sweep.py")])


def main(argv=None) -> int:
    from flexflow_tpu_torch.analysis.lint import ALL_RULES, lint_paths

    argv = list(sys.argv[1:] if argv is None else argv)
    select = None
    paths = []
    i = 0
    while i < len(argv):
        a = argv[i]
        if a == "--select":
            i += 1
            select = tuple(r.strip() for r in argv[i].split(",")
                           if r.strip())
            unknown = set(select) - set(ALL_RULES)
            if unknown:
                print(f"fflint: unknown rule(s) {sorted(unknown)} "
                      f"(have {ALL_RULES})", file=sys.stderr)
                return 2
        elif a in ("-h", "--help"):
            print(__doc__)
            return 0
        else:
            paths.append(a)
        i += 1

    if not paths:
        paths = default_paths()
    paths = [p for p in paths if os.path.exists(p)]

    findings = lint_paths(paths, select=select)
    for f in findings:
        print(f)
    n_err = sum(1 for f in findings if f.severity == "error")
    n_warn = len(findings) - n_err
    if findings:
        print(f"fflint: {n_err} error(s), {n_warn} warning(s) — "
              f"fix or suppress with '# fflint: ok <rule>'",
              file=sys.stderr)
        return 1
    print(f"fflint: clean ({len(paths)} path(s), rules: "
          f"{', '.join(select or ALL_RULES)})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
