"""fflint: AST rules for the hazards of the PyTorch port (twin of
`flexflow_tpu/analysis/lint.py`), each aimed at the port's form of the
bug class the JAX package's rule encodes:

- `host_sync_in_loop` — a host sync (`.item()`, `.tolist()`, `.cpu()`,
  `torch.cuda.synchronize()`) inside a `for`/`while` loop: a device drain
  per iteration, what the chunked engine exists to remove from the step
  loop. Syncs behind a telemetry/diagnostics gate are exempt (the gate IS
  the fix), including gates bound to a local (`need_losses = tel is not
  None`).
- `unsorted_dict_hash` — a `for` loop over `.items()`/`.keys()`/
  `.values()` (not wrapped in `sorted(...)`) inside a fingerprint/hash
  function: dict order is insertion order, so two processes that learned
  entries in different orders hash differently.
- `global_rng` — module-level `np.random.*` / stdlib `random.*` calls and
  `torch.manual_seed` (not seeded generator instances): the process-global
  RNG makes resume and multi-rank runs non-replayable.
- `time_in_trace` — `time.*` / host RNG calls inside a function captured
  into a CUDA graph: the `fn` given to `Executor._compiled` /
  `CapturedStep`, or the body of a `torch.cuda.graph(...)` block. They run
  once, at capture, and every replay reuses the value.
- `coordinator_collective` — a collective (`barrier`, `broadcast_json`,
  `gather_json`, the `torch.distributed` collectives, `new_group`) inside
  an `is_coordinator()` / `rank == 0` branch: the other ranks never reach
  it and the mesh deadlocks. The idiom is `broadcast_json(payload if
  is_coordinator() else None)`: gate the PAYLOAD, not the collective.
- `donated_reuse` — the port's donation is in place: a captured step
  holds its tensors at fixed positions (the `held=` of
  `Executor._compiled`) and its replay rewrites them. An alias of a held
  argument taken before the call (`before = self._params["fc"]`) and read
  after it is the NEW value, not the old one it names. Take a copy
  (`.clone()`) instead.
- `low_precision_accum` — a summing reduction (`sum`/`mean`/`prod`/
  `cumsum`/`logsumexp`/`einsum`) over an argument cast to bf16/fp16
  (`.to(torch.bfloat16)`, `.half()`, `.bfloat16()`) or with such a
  `dtype=`: long low-precision sums drift; reduce in f32 and downcast
  once (loss.py, ops/core.py).
- `host_divergent_branch` — an `if` whose test calls a per-host
  nondeterministic source (time.*, RNG, os.environ/getenv,
  socket.gethostname) guarding a collective (deadlock: error) or a
  capture entry (ranks capture divergent graphs: warning).
- `unverified_transition` — a direct call of a state re-placement
  applier (`restore_tree`, `place_like`, `place_update_sharded`) in a
  function that never consults the fftrans checker (analysis/
  transition.py).
- `raw_timer_in_hot_path` — two or more bare `time.perf_counter()` /
  `time.time()` reads inside a step/decode/prefill function outside
  `telemetry/`: a measurement the metrics plane never sees.
- `unverified_rule_load` — a call that loads or builds `GraphXfer`s
  (`load_rule_collection` without `config=`, `compile_pattern_rule`,
  `generate_all_pcg_xfers`) in a function that never consults the
  ffrules verifier (analysis/rules.py).
- `unnamed_op_scope` — an op dispatch (`*.op_def.forward` /
  `*.op_def.backward`) in executor.py or ops/ outside a `with
  self._scope(...)` / `record_function(...)` / `executor.scoped()` block:
  the port's attribution joins kernels to PCG nodes by those ranges
  (scope/attribution.py), so an unscoped dispatch is device time it can
  only file as unattributed.

Suppression: a trailing `# fflint: ok` (optionally naming codes,
`# fflint: ok host_sync_in_loop`) on the flagged line or its enclosing
`def` line, where the hazard is the point (calibration timing loops sync
inside a loop by design).

The ffcheck pass pipeline reuses `coordinator_collective`,
`donated_reuse` and `host_divergent_branch` as its source-level checks
(analysis/sources.py).
"""

from __future__ import annotations

import ast
import os

from .findings import Finding, SEV_ERROR, SEV_WARNING

PASS_NAME = "fflint"

ALL_RULES = ("host_sync_in_loop", "unsorted_dict_hash", "global_rng",
             "time_in_trace", "coordinator_collective", "donated_reuse",
             "low_precision_accum", "host_divergent_branch",
             "unverified_transition", "unverified_rule_load",
             "raw_timer_in_hot_path", "unnamed_op_scope")

# identifiers whose presence in an `if` test marks the branch as a
# telemetry/diagnostics gate (a gated sync is the sanctioned pattern)
_GATE_IDS = ("tel", "telemetry", "diag", "diagnostics", "sampled",
             "verbose", "profiling", "debug")

# host syncs: tensor methods that copy to the host, and the explicit
# device drain
_SYNC_METHODS = {"item", "tolist", "cpu"}
_SYNC_CALLS = {"torch.cuda.synchronize", "cuda.synchronize"}

_TIME_FUNCS = {"time", "perf_counter", "monotonic", "process_time",
               "time_ns", "perf_counter_ns", "monotonic_ns"}
_NP_RANDOM_OK = {"RandomState", "default_rng", "Generator",
                 "SeedSequence", "PCG64", "Philox", "MT19937"}
_PY_RANDOM_FUNCS = {"random", "randint", "choice", "choices", "shuffle",
                    "seed", "uniform", "randrange", "sample", "gauss",
                    "betavariate", "getrandbits"}
_TORCH_GLOBAL_RNG = {"torch.manual_seed", "torch.seed",
                     "torch.cuda.manual_seed", "torch.cuda.manual_seed_all"}
# collectives: the port's JSON channel and torch.distributed's (a new
# group is collective too: every rank makes every group)
_COLLECTIVES = {"barrier", "broadcast_json", "gather_json", "all_reduce",
                "all_gather", "all_gather_into_tensor", "all_gather_object",
                "all_to_all", "all_to_all_single", "broadcast",
                "broadcast_object_list", "reduce_scatter",
                "reduce_scatter_tensor", "batch_isend_irecv", "new_group",
                "monitored_barrier"}
# the entries that capture a function into a CUDA graph
_TRACE_ENTRY = {"_compiled", "CapturedStep"}
_GRAPH_BLOCKS = {"graph"}  # `with torch.cuda.graph(g):`

# captured-step callees (by last identifier) -> the positions they hold
# and rewrite in place. MUST match the `held=` of each `build_*` in
# executor.py: the ffcheck donation pass cross-checks this registry
# against executor.py's AST (analysis/donation.py).
DONATED_CALLEES = {
    "step_fn": (0, 1, 2, 3, 4, 6),     # build_train_step
    "_train_step": (0, 1, 2, 3, 4, 6),
    "chunk_fn": (0, 1, 2, 3, 4, 6),    # build_chunked_train_step
    "eval_fn": (0, 1, 2),              # build_eval_step
    "_eval_step": (0, 1, 2),
    "_step_fn": (0, 1, 4),             # build_decode_step (KV state, gen)
    "_decode_step": (0, 1, 4),
    "_verify_fn": (0, 1),               # build_verify_step (speculative)
    "_verify_step": (0, 1),
    "_inject_fn": (0,),                 # build_kv_inject (disagg handoff)
}

_HASH_FN_HINTS = ("fingerprint", "signature", "digest", "_sha", "hash")

# state re-placement appliers and the fftrans checker entry points that
# gate them (analysis/transition.py)
_TRANSITION_APPLIERS = {"place_update_sharded", "place_like",
                        "restore_tree"}
_TRANSITION_CHECKERS = {"verify_restore_transition", "verify_transition",
                        "gate_transition", "build_transition_plan",
                        "plan_model_transition", "migrate_state"}

# GraphXfer construct/load surface (search/substitution.py) and the
# ffrules checker entry points that gate it (analysis/rules.py)
_RULE_LOADERS = {"load_rule_collection", "compile_pattern_rule",
                 "generate_all_pcg_xfers"}
_RULE_CHECKERS = {"verify_rule", "verify_rules", "verify_registry",
                  "gate_loaded_rules", "RuleVerificationError"}

# summing reductions the low-precision-accumulation rule watches
_SUM_FUNCS = {"sum", "mean", "prod", "cumsum", "logsumexp", "einsum",
              "nansum"}
_LOW_DTYPES = ("bfloat16", "float16", "half")

# hot-path function name hints for the raw-timer rule
_HOT_PATH_HINTS = ("step", "decode", "prefill")
_BARE_TIMER_NAMES = {"perf_counter", "monotonic", "perf_counter_ns",
                     "monotonic_ns"}

# the context managers that open an attribution range around a dispatch
_SCOPE_CALLS = {"_scope", "record_function", "scoped", "named_scope"}


def _dotted(node) -> str:
    """Name/Attribute chain → dotted string ('' when not a pure chain)."""
    parts = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return ""


def _last_ident(node) -> str:
    if isinstance(node, ast.Attribute):
        return node.attr
    if isinstance(node, ast.Name):
        return node.id
    return ""


class _FileLint:
    def __init__(self, src: str, path: str, select):
        self.tree = ast.parse(src)
        self.lines = src.splitlines()
        self.path = path
        self.select = set(select) if select else set(ALL_RULES)
        self.findings: list[Finding] = []
        self._parent_map = None  # built lazily (one full-tree walk)

    @property
    def _parents(self) -> dict:
        if self._parent_map is None:
            self._parent_map = {}
            for parent in ast.walk(self.tree):
                for child in ast.iter_child_nodes(parent):
                    self._parent_map[id(child)] = parent
        return self._parent_map

    # ------------------------------------------------------------ pragmas

    def _suppressed(self, node, code: str) -> bool:
        for ln in {getattr(node, "lineno", 0), self._def_line(node)}:
            if not (0 < ln <= len(self.lines)):
                continue
            line = self.lines[ln - 1]
            if "# fflint: ok" not in line:
                continue
            tail = line.split("# fflint: ok", 1)[1].strip()
            listed = [t.strip(",") for t in tail.split()
                      if t.strip(",") in ALL_RULES]
            if not listed or code in listed:
                return True
        return False

    def _def_line(self, node) -> int:
        cur = node
        while cur is not None:
            if isinstance(cur, (ast.FunctionDef, ast.AsyncFunctionDef)):
                return cur.lineno
            cur = self._parents.get(id(cur))
        return 0

    def _emit(self, node, severity, code, message, **details):
        if code not in self.select or self._suppressed(node, code):
            return
        self.findings.append(Finding(
            severity, code, message, pass_name=PASS_NAME,
            where=f"{self.path}:{getattr(node, 'lineno', 0)}",
            details=details or {}))

    # --------------------------------------------------------- rule: sync

    def _gate_names(self, fn) -> set:
        """Gate identifiers for one function: the builtin set plus any
        local assigned FROM a gated expression (need_losses = tel is not
        None)."""
        gates = set(_GATE_IDS)
        changed = True
        while changed:
            changed = False
            for node in ast.walk(fn):
                if not (isinstance(node, ast.Assign)
                        and len(node.targets) == 1
                        and isinstance(node.targets[0], ast.Name)):
                    continue
                tgt = node.targets[0].id
                if tgt in gates:
                    continue
                idents = {n.id for n in ast.walk(node.value)
                          if isinstance(n, ast.Name)}
                idents |= {n.attr for n in ast.walk(node.value)
                           if isinstance(n, ast.Attribute)}
                if any(any(g in i for g in gates) for i in idents):
                    gates.add(tgt)
                    changed = True
        return gates

    def _mentions_gate(self, test, gates) -> bool:
        for n in ast.walk(test):
            ident = ""
            if isinstance(n, ast.Name):
                ident = n.id
            elif isinstance(n, ast.Attribute):
                ident = n.attr
            if ident and any(g in ident for g in gates):
                return True
        return False

    def rule_host_sync_in_loop(self):
        for fn in ast.walk(self.tree):
            if not isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef)):
                continue
            gates = self._gate_names(fn)
            self._scan_sync(fn.body, gates, in_loop=False, gated=False)

    def _scan_sync(self, stmts, gates, in_loop, gated):
        for node in stmts:
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                continue  # nested defs get their own pass
            if isinstance(node, (ast.For, ast.While)):
                self._scan_sync(node.body, gates, True, gated)
                self._scan_sync(node.orelse, gates, in_loop, gated)
                continue
            if isinstance(node, ast.If):
                g = gated or self._mentions_gate(node.test, gates)
                self._scan_sync(node.body, gates, in_loop, g)
                self._scan_sync(node.orelse, gates, in_loop, g)
                continue
            if isinstance(node, ast.With):
                self._scan_sync(node.body, gates, in_loop, gated)
                continue
            if isinstance(node, ast.Try):
                for sub in (node.body, node.orelse, node.finalbody):
                    self._scan_sync(sub, gates, in_loop, gated)
                for h in node.handlers:
                    self._scan_sync(h.body, gates, in_loop, gated)
                continue
            if not in_loop:
                continue
            for call in ast.walk(node):
                if not isinstance(call, ast.Call):
                    continue
                what = self._sync_call(call)
                if not what:
                    continue
                g = gated
                # conditional-expression gate: x if need_losses else None
                cur = call
                while cur is not None and not g:
                    if isinstance(cur, ast.IfExp) and \
                            self._mentions_gate(cur.test, gates):
                        g = True
                    cur = self._parents.get(id(cur))
                    if isinstance(cur, ast.stmt):
                        break
                if g:
                    continue
                self._emit(
                    call, SEV_WARNING, "host_sync_in_loop",
                    f"{what} inside a loop is a per-iteration device "
                    f"drain — hoist it out, batch it per chunk, or gate "
                    f"it behind telemetry/diagnostics")

    @staticmethod
    def _sync_call(call) -> str:
        """The host sync a call is ('' when none): a tensor's `.item()`,
        `.tolist()` or `.cpu()`, or `torch.cuda.synchronize()`."""
        d = _dotted(call.func)
        if d in _SYNC_CALLS:
            return f"{d}()"
        if (isinstance(call.func, ast.Attribute)
                and call.func.attr in _SYNC_METHODS and not call.args
                and not call.keywords):
            return f".{call.func.attr}()"
        return ""

    # --------------------------------------------------- rule: dict hash

    def rule_unsorted_dict_hash(self):
        for fn in ast.walk(self.tree):
            if not isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef)):
                continue
            hashy = any(h in fn.name.lower() for h in _HASH_FN_HINTS)
            if not hashy:
                for call in ast.walk(fn):
                    if isinstance(call, ast.Call):
                        d = _dotted(call.func)
                        if d.startswith("hashlib.") or \
                                _last_ident(call.func) == "_sha":
                            hashy = True
                            break
            if not hashy:
                continue
            for node in ast.walk(fn):
                if not isinstance(node, ast.For):
                    continue
                it = node.iter
                if isinstance(it, ast.Call) and \
                        isinstance(it.func, ast.Attribute) and \
                        it.func.attr in ("items", "keys", "values"):
                    self._emit(
                        node, SEV_WARNING, "unsorted_dict_hash",
                        f"iteration over .{it.func.attr}() inside hash "
                        f"function {fn.name}(): dict order is insertion "
                        f"order — wrap in sorted(...) so the digest is "
                        f"order-free")

    # --------------------------------------------------- rule: global rng

    def _rng_call(self, call) -> str:
        d = _dotted(call.func)
        parts = d.split(".")
        if len(parts) >= 3 and parts[-3] in ("np", "numpy") \
                and parts[-2] == "random" and \
                parts[-1] not in _NP_RANDOM_OK:
            return d
        if len(parts) == 2 and parts[0] == "random" \
                and parts[1] in _PY_RANDOM_FUNCS:
            return d
        if d in _TORCH_GLOBAL_RNG:
            return d
        return ""

    def rule_global_rng(self):
        for call in ast.walk(self.tree):
            if not isinstance(call, ast.Call):
                continue
            d = self._rng_call(call)
            if d:
                self._emit(
                    call, SEV_WARNING, "global_rng",
                    f"{d}() uses the process-global RNG — a seeded "
                    f"np.random.RandomState / torch.Generator keeps "
                    f"resume and multi-rank runs replayable")

    # --------------------------------------------- rule: time in capture

    def _traced_regions(self) -> list:
        """The code a CUDA graph captures: each def referenced (possibly
        through functools.partial) as an argument of a capture entry
        (`Executor._compiled`, `CapturedStep`), every def nested in one,
        and the body of each `with torch.cuda.graph(...)` block. Returns
        [(region node, label)]."""
        defs_by_name: dict[str, list] = {}
        for node in ast.walk(self.tree):
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                defs_by_name.setdefault(node.name, []).append(node)
        marked: dict[int, ast.AST] = {}
        blocks = []
        for node in ast.walk(self.tree):
            if isinstance(node, ast.With):
                for item in node.items:
                    ce = item.context_expr
                    if (isinstance(ce, ast.Call)
                            and _last_ident(ce.func) in _GRAPH_BLOCKS
                            and "cuda" in _dotted(ce.func).split(".")):
                        blocks.append(node)
            if not isinstance(node, ast.Call):
                continue
            if _last_ident(node.func) not in _TRACE_ENTRY:
                continue
            cands = list(node.args) + [k.value for k in node.keywords]
            for arg in cands:
                if isinstance(arg, ast.Call) and \
                        _last_ident(arg.func) == "partial" and arg.args:
                    arg = arg.args[0]
                if isinstance(arg, (ast.Name, ast.Attribute)):
                    for d in defs_by_name.get(_last_ident(arg), []):
                        marked[id(d)] = d
        # nested defs inside a captured def are captured with it
        out = dict(marked)
        for d in list(marked.values()):
            for sub in ast.walk(d):
                if isinstance(sub, (ast.FunctionDef, ast.AsyncFunctionDef)):
                    out.setdefault(id(sub), sub)
        regions = [(d, f"captured function {d.name}()")
                   for d in out.values()]
        regions += [(w, "a torch.cuda.graph block") for w in blocks]
        return regions

    def rule_time_in_trace(self):
        seen: set[int] = set()
        for region, label in self._traced_regions():
            for call in ast.walk(region):
                if not isinstance(call, ast.Call) or id(call) in seen:
                    continue
                d = _dotted(call.func)
                parts = d.split(".")
                bad = ""
                if len(parts) == 2 and parts[0] == "time" \
                        and parts[1] in _TIME_FUNCS:
                    bad = d
                elif d in ("datetime.now", "datetime.datetime.now",
                           "datetime.utcnow"):
                    bad = d
                elif self._rng_call(call):
                    bad = self._rng_call(call)
                if bad:
                    seen.add(id(call))
                    self._emit(
                        call, SEV_ERROR, "time_in_trace",
                        f"{bad}() inside {label} runs ONCE, at capture, "
                        f"and every replay of the CUDA graph reuses its "
                        f"value")

    # ------------------------------------- rule: coordinator collective

    def _is_coordinator_test(self, test) -> tuple[bool, bool]:
        """(gates_body, gates_orelse): does this `if` test make one
        branch coordinator-only? Handles `is_coordinator()`, a rank
        compared with 0 (`rank == 0`, `dist.get_rank() == 0`,
        `process_index() == 0`, `self.mesh.rank == 0`) and their
        negations."""
        neg = False
        inner = test
        while isinstance(inner, ast.UnaryOp) and \
                isinstance(inner.op, ast.Not):
            neg = not neg
            inner = inner.operand
        coord = False
        for n in ast.walk(inner):
            if isinstance(n, ast.Call) and \
                    _last_ident(n.func) == "is_coordinator":
                coord = True
            if isinstance(n, ast.Compare) and self._is_rank(n.left) \
                    and len(n.comparators) == 1 \
                    and isinstance(n.comparators[0], ast.Constant) \
                    and n.comparators[0].value == 0:
                if isinstance(n.ops[0], ast.Eq):
                    coord = True
                elif isinstance(n.ops[0], ast.NotEq) and n is inner:
                    coord, neg = True, not neg
        if not coord:
            return False, False
        return (not neg, neg)

    @staticmethod
    def _is_rank(node) -> bool:
        if isinstance(node, ast.Call):
            return _last_ident(node.func) in ("process_index", "get_rank")
        return _last_ident(node) in ("rank", "process_index")

    def rule_coordinator_collective(self):
        for node in ast.walk(self.tree):
            if not isinstance(node, ast.If):
                continue
            body_coord, orelse_coord = self._is_coordinator_test(node.test)
            for stmts, flagged in ((node.body, body_coord),
                                   (node.orelse, orelse_coord)):
                if not flagged:
                    continue
                for sub in stmts:
                    for call in ast.walk(sub):
                        if isinstance(call, ast.Call) and \
                                _last_ident(call.func) in _COLLECTIVES:
                            self._emit(
                                call, SEV_ERROR, "coordinator_collective",
                                f"collective "
                                f"{_last_ident(call.func)}() inside a "
                                f"coordinator-only branch: the other "
                                f"ranks never reach it — the mesh "
                                f"deadlocks. Gate the PAYLOAD, not the "
                                f"collective (broadcast_json(x if "
                                f"is_coordinator() else None))")

    # ------------------------------------------- rule: donated reuse

    @staticmethod
    def _aliases(value, expr: str) -> bool:
        """Does `value` name `expr` or a part of it (a subscript or
        attribute chain rooted at it, no call in between, so no copy)?"""
        cur = value
        while True:
            if isinstance(cur, (ast.Name, ast.Attribute)) \
                    and _dotted(cur) == expr:
                return True
            if isinstance(cur, (ast.Subscript, ast.Attribute)):
                cur = cur.value
                continue
            return False

    def rule_donated_reuse(self):
        # one cheap pre-scan: most files (and most functions) never call
        # a captured step; only collect per-function load/store events
        # where such a call appears
        calls = [n for n in ast.walk(self.tree)
                 if isinstance(n, ast.Call)
                 and _last_ident(n.func) in DONATED_CALLEES]
        if not calls:
            return
        involved: dict[int, ast.AST] = {}
        for c in calls:
            cur = self._parents.get(id(c))
            while cur is not None and not isinstance(
                    cur, (ast.FunctionDef, ast.AsyncFunctionDef)):
                cur = self._parents.get(id(cur))
            if cur is not None:
                involved.setdefault(id(cur), cur)
        for fn in involved.values():
            events = []  # (lineno, col, kind, expr string)
            assigns = []  # (lineno, alias, value)
            for node in ast.walk(fn):
                if isinstance(node, ast.Assign) and len(node.targets) == 1 \
                        and isinstance(node.targets[0],
                                       (ast.Name, ast.Attribute)):
                    alias = _dotted(node.targets[0])
                    if alias:
                        assigns.append((node.lineno, alias, node.value))
                d = ""
                if isinstance(node, (ast.Name, ast.Attribute)):
                    d = _dotted(node)
                if not d:
                    continue
                kind = ("store" if isinstance(
                    getattr(node, "ctx", None), ast.Store) else "load")
                events.append((node.lineno, node.col_offset, kind, d))
            events.sort()
            for node in ast.walk(fn):
                if not isinstance(node, ast.Call):
                    continue
                callee = _last_ident(node.func)
                held = DONATED_CALLEES.get(callee)
                if held is None:
                    continue
                stmt = self._enclosing_stmt(node)
                start = getattr(stmt, "lineno", node.lineno)
                end = getattr(stmt, "end_lineno", node.lineno)
                for argnum in held:
                    if argnum >= len(node.args):
                        continue
                    arg = node.args[argnum]
                    if not isinstance(arg, (ast.Name, ast.Attribute)):
                        continue
                    expr = _dotted(arg)
                    if not expr:
                        continue
                    for line, alias, value in assigns:
                        if line >= start or alias == expr \
                                or not self._aliases(value, expr):
                            continue
                        # the alias still holds this value at the call
                        if any(e[0] > line and e[0] < start
                               and e[2] == "store" and e[3] == alias
                               for e in events):
                            continue
                        nxt = next((e for e in events
                                    if e[0] > end and e[3] == alias), None)
                        if nxt is not None and nxt[2] == "load":
                            self._emit(
                                node, SEV_ERROR, "donated_reuse",
                                f"{alias} aliases {expr} (held at "
                                f"position {argnum} of {callee}(), "
                                f"rewritten in place by the replay) and "
                                f"is read at line {nxt[0]} as if it held "
                                f"the value from before the call — take "
                                f"a .clone() before the call",
                                reuse_line=nxt[0], argnum=argnum)

    def _enclosing_stmt(self, node):
        cur = node
        while cur is not None and not isinstance(cur, ast.stmt):
            cur = self._parents.get(id(cur))
        return cur

    # --------------------------------------- rule: low-precision accum

    @staticmethod
    def _low_name(node) -> str:
        d = _dotted(node) or (node.value if isinstance(node, ast.Constant)
                              and isinstance(node.value, str) else "")
        if isinstance(d, str) and d.split(".")[-1] in _LOW_DTYPES:
            return d
        return ""

    def _low_precision_expr(self, node) -> str:
        """Name of the low-precision dtype an expression subtree casts to
        ('' when none): `.to(torch.bfloat16)`, `.type(...)`, `.astype
        (...)` (numpy), `.half()`, `.bfloat16()`."""
        for sub in ast.walk(node):
            if not isinstance(sub, ast.Call):
                continue
            name = _last_ident(sub.func)
            if name in ("to", "type", "astype"):
                for a in list(sub.args) + [k.value for k in sub.keywords
                                           if k.arg == "dtype"]:
                    d = self._low_name(a)
                    if d:
                        return d
            elif name in ("half", "bfloat16") and \
                    isinstance(sub.func, ast.Attribute) and not sub.args:
                return name
        return ""

    def rule_low_precision_accum(self):
        for call in ast.walk(self.tree):
            if not isinstance(call, ast.Call):
                continue
            if _last_ident(call.func) not in _SUM_FUNCS:
                continue
            lp = ""
            for kw in call.keywords:
                if kw.arg in ("dtype", "preferred_element_type"):
                    lp = self._low_name(kw.value) or lp
            operands = list(call.args)
            if isinstance(call.func, ast.Attribute):
                operands.append(call.func.value)  # x.to(bf16).sum()
            if not lp:
                for a in operands:
                    lp = self._low_precision_expr(a)
                    if lp:
                        break
            if lp:
                self._emit(
                    call, SEV_WARNING, "low_precision_accum",
                    f"{_last_ident(call.func)}() accumulates in "
                    f"{lp.split('.')[-1]} — long low-precision sums "
                    f"drift; reduce in f32 and downcast the result "
                    f"(loss.py / ops/core.py convention)")

    # ------------------------------------ rule: host-divergent branch

    def _divergent_source(self, test) -> str:
        """Dotted name of a per-host-nondeterministic call in an `if`
        test ('' when none)."""
        for n in ast.walk(test):
            if not isinstance(n, ast.Call):
                continue
            d = _dotted(n.func)
            parts = d.split(".")
            if len(parts) == 2 and parts[0] == "time" \
                    and parts[1] in _TIME_FUNCS:
                return d
            if self._rng_call(n):
                return d
            if d in ("os.getenv", "os.environ.get",
                     "socket.gethostname", "platform.node"):
                return d
        return ""

    def rule_host_divergent_branch(self):
        for node in ast.walk(self.tree):
            if not isinstance(node, ast.If):
                continue
            src = self._divergent_source(node.test)
            if not src:
                continue
            for stmts in (node.body, node.orelse):
                for sub in stmts:
                    for call in ast.walk(sub):
                        if not isinstance(call, ast.Call):
                            continue
                        callee = _last_ident(call.func)
                        if callee in _COLLECTIVES:
                            self._emit(
                                call, SEV_ERROR,
                                "host_divergent_branch",
                                f"collective {callee}() behind a branch "
                                f"on {src}() — ranks evaluate the test "
                                f"differently and some never reach the "
                                f"collective: the mesh deadlocks. Decide "
                                f"on the coordinator and broadcast_json "
                                f"the verdict", source=src)
                        elif callee in _TRACE_ENTRY:
                            self._emit(
                                call, SEV_WARNING,
                                "host_divergent_branch",
                                f"capture entry {callee}() behind a "
                                f"branch on {src}() — ranks may capture "
                                f"divergent CUDA graphs; key the "
                                f"decision on broadcast state",
                                source=src)

    # ------------------------------------ rule: unverified transition

    def _enclosing_def(self, node):
        cur = self._parents.get(id(node))
        while cur is not None and not isinstance(
                cur, (ast.FunctionDef, ast.AsyncFunctionDef)):
            cur = self._parents.get(id(cur))
        return cur

    def rule_unverified_transition(self):
        calls = [n for n in ast.walk(self.tree)
                 if isinstance(n, ast.Call)
                 and _last_ident(n.func) in _TRANSITION_APPLIERS]
        if not calls:
            return
        # checker references per enclosing def (None = module level):
        # any Name/Attribute mention counts — the gate may be called,
        # passed, or imported-and-called under an alias attribute
        gated_scopes: set[int] = set()
        for node in ast.walk(self.tree):
            ident = ""
            if isinstance(node, ast.Name):
                ident = node.id
            elif isinstance(node, ast.Attribute):
                ident = node.attr
            if ident in _TRANSITION_CHECKERS:
                scope = self._enclosing_def(node)
                gated_scopes.add(id(scope) if scope is not None else 0)
        for call in calls:
            scope = self._enclosing_def(call)
            sid = id(scope) if scope is not None else 0
            if sid in gated_scopes:
                continue
            callee = _last_ident(call.func)
            self._emit(
                call, SEV_WARNING, "unverified_transition",
                f"{callee}() re-places state outside the fftrans "
                f"checker-gated path — a dropped mapping / dtype drift "
                f"/ missing gather path here surfaces as corruption "
                f"mid-restore; route through migrate_state / "
                f"verify_restore_transition (fresh-init placement at "
                f"compile is exempt: pragma it)")

    # ------------------------------------ rule: unverified rule load

    def rule_unverified_rule_load(self):
        calls = [n for n in ast.walk(self.tree)
                 if isinstance(n, ast.Call)
                 and _last_ident(n.func) in _RULE_LOADERS]
        if not calls:
            return
        gated_scopes: set[int] = set()
        for node in ast.walk(self.tree):
            ident = ""
            if isinstance(node, ast.Name):
                ident = node.id
            elif isinstance(node, ast.Attribute):
                ident = node.attr
            if ident in _RULE_CHECKERS:
                scope = self._enclosing_def(node)
                gated_scopes.add(id(scope) if scope is not None else 0)
        def _is_none(node) -> bool:
            return isinstance(node, ast.Constant) and node.value is None

        for call in calls:
            callee = _last_ident(call.func)
            if callee == "load_rule_collection":
                # the loader verifies internally when handed a config
                # (keyword or third positional) — that call IS the
                # gate. A literal None is NOT a config: the loader
                # skips verification for it.
                gated = any(kw.arg == "config" and not _is_none(kw.value)
                            for kw in call.keywords)
                if len(call.args) >= 3 and not _is_none(call.args[2]):
                    gated = True
                if gated:
                    continue
            scope = self._enclosing_def(call)
            sid = id(scope) if scope is not None else 0
            if sid in gated_scopes:
                continue
            self._emit(
                call, SEV_WARNING, "unverified_rule_load",
                f"{callee}() constructs/loads GraphXfers outside an "
                f"ffrules-verifier-consulting function — an unsound "
                f"rule injected into the search becomes a silently "
                f"wrong plan; pass config= to load_rule_collection or "
                f"route through analysis.rules.verify_rules (the "
                f"CI-swept built-in registry is exempt: pragma it)")

    # ---------------------------------- rule: raw timer in hot path

    def _timer_call(self, call) -> str:
        d = _dotted(call.func)
        parts = d.split(".")
        if len(parts) == 2 and parts[0] == "time" \
                and parts[1] in _TIME_FUNCS:
            return d
        if len(parts) == 1 and parts[0] in _BARE_TIMER_NAMES:
            return d
        return ""

    def rule_raw_timer_in_hot_path(self):
        # telemetry/ is the one place raw clock reads are the point:
        # the span/observe implementations themselves
        if "telemetry" in os.path.normpath(self.path).split(os.sep):
            return
        for fn in ast.walk(self.tree):
            if not isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef)):
                continue
            if not any(h in fn.name.lower() for h in _HOT_PATH_HINTS):
                continue
            gates = self._gate_names(fn)
            timers = []
            for call in ast.walk(fn):
                if not isinstance(call, ast.Call) or \
                        not self._timer_call(call):
                    continue
                if self._enclosing_def(call) is not fn:
                    continue  # nested defs get their own pass
                # a read inside an `if tel is not None:` branch is the
                # sanctioned gated-measurement idiom
                gated = False
                cur = self._parents.get(id(call))
                while cur is not None and cur is not fn:
                    if isinstance(cur, ast.If) and \
                            self._mentions_gate(cur.test, gates):
                        gated = True
                        break
                    cur = self._parents.get(id(cur))
                if not gated:
                    timers.append(call)
            if len(timers) < 2:
                continue  # a lone read is not a measurement pair
            second = sorted(timers, key=lambda c: (c.lineno,
                                                   c.col_offset))[1]
            self._emit(
                second, SEV_WARNING, "raw_timer_in_hot_path",
                f"{len(timers)} bare timer reads in hot-path function "
                f"{fn.name}() — a hand-rolled start/stop pair the "
                f"metrics plane never sees; wrap the region in "
                f"telemetry.span(...) or feed the delta to "
                f"telemetry.observe(...) so it lands in the mergeable "
                f"histograms", timer_reads=len(timers))

    # ------------------------------------ rule: unnamed op scope

    def rule_unnamed_op_scope(self):
        # only where op dispatch lives: the executor's forward paths and
        # the ops/ package (the cost model's calibration harness times
        # ops standalone, with no profile to attribute)
        parts = os.path.normpath(self.path).split(os.sep)
        if os.path.basename(self.path) != "executor.py" \
                and "ops" not in parts:
            return
        for call in ast.walk(self.tree):
            if not isinstance(call, ast.Call):
                continue
            d = _dotted(call.func)
            if not (d.endswith(".op_def.forward")
                    or d.endswith(".op_def.backward")
                    or d in ("op_def.forward", "op_def.backward")):
                continue
            named = False
            cur = self._parents.get(id(call))
            while cur is not None:
                if isinstance(cur, ast.With):
                    for item in cur.items:
                        ce = item.context_expr
                        if isinstance(ce, ast.Call) and \
                                _last_ident(ce.func) in _SCOPE_CALLS:
                            named = True
                if isinstance(cur, (ast.FunctionDef,
                                    ast.AsyncFunctionDef)):
                    break  # runtime nesting is invisible past a def
                cur = self._parents.get(id(cur))
            if named:
                continue
            self._emit(
                call, SEV_WARNING, "unnamed_op_scope",
                f"{d}() dispatched outside a record_function range — "
                f"its device time cannot be attributed back to the PCG "
                f"node (scope/attribution.py joins kernels to the "
                f"ranges); wrap the dispatch in `with "
                f"self._scope(node.name):` (a dispatch that runs under a "
                f"caller's range is exempt: pragma it)")

    # ---------------------------------------------------------------- run

    def run(self) -> list[Finding]:
        for rule in ALL_RULES:
            if rule in self.select:
                getattr(self, f"rule_{rule}")()
        self.findings.sort(key=lambda f: f.where)
        return self.findings


def lint_source(src: str, path: str = "<string>",
                select=None) -> list[Finding]:
    """Lint one source string. Raises SyntaxError on unparseable input."""
    return _FileLint(src, path, select).run()


def lint_file(path: str, select=None) -> list[Finding]:
    with open(path, encoding="utf-8") as f:
        src = f.read()
    try:
        return lint_source(src, path, select)
    except SyntaxError as e:
        return [Finding(SEV_ERROR, "parse_error",
                        f"could not parse: {e}", pass_name=PASS_NAME,
                        where=f"{path}:{e.lineno or 0}")]


_EXCLUDE_DIRS = {"__pycache__", ".git", ".github", "node_modules"}


def iter_py_files(root: str, exclude=()):
    exclude = set(exclude)
    for dirpath, dirnames, filenames in os.walk(root):
        dirnames[:] = sorted(d for d in dirnames
                             if d not in _EXCLUDE_DIRS and d not in exclude)
        for fn in sorted(filenames):
            if fn.endswith(".py"):
                yield os.path.join(dirpath, fn)


def lint_paths(paths, select=None, exclude=()) -> list[Finding]:
    findings: list[Finding] = []
    for p in paths:
        if os.path.isdir(p):
            for f in iter_py_files(p, exclude=exclude):
                findings.extend(lint_file(f, select))
        else:
            findings.extend(lint_file(p, select))
    return findings
