"""grape-lint's AST checks over this package's source: R4, R5, R6, R7, R8,
R9, R10, R11 and R12.

Counterpart of `libgrape_lite_tpu/analysis/astlint.py`: the same scope
engine and, for each rule this package carries, the same checker with its
paths and module names pointing at `libgrape_lite_tpu_torch`.  The analysis
is intraprocedural and anchored on the idioms the code uses (the dyn view
checks, the pump's dispatch stage, the stats federation, the result cache
key, the rate profile), so it needs no annotations; intentional exceptions
are named in analysis/baseline.json.  Port-only difference: R7 also knows
PyTorch's sync forcers (`.cpu()`, `.numpy()`, `synchronize()`).

Entry points: `lint_source(src, relpath)` for one module,
`lint_paths(paths, root=...)` for trees (skips __pycache__ / scratch).
"""

from __future__ import annotations

import ast
import os
import re
from typing import Dict, List, Optional, Set

from libgrape_lite_tpu_torch.analysis.report import Finding

_PACKAGE = "libgrape_lite_tpu_torch"
_ARRAY_MODULES = {"np", "jnp", "numpy"}


class _Scope:
    def __init__(self, node, name: str, parent: Optional["_Scope"],
                 kind: str):
        self.node = node
        self.name = name
        self.parent = parent
        self.kind = kind  # module | class | function
        self.children: List[_Scope] = []
        self.params: Set[str] = set()
        self.assign_values: Dict[str, ast.AST] = {}
        self.calls: List[ast.Call] = []
        if parent is not None:
            parent.children.append(self)

    @property
    def qualname(self) -> str:
        parts = []
        s = self
        while s is not None and s.kind != "module":
            parts.append(s.name)
            s = s.parent
        return ".".join(reversed(parts)) or "<module>"


def _callee_base(func) -> Optional[str]:
    if isinstance(func, ast.Attribute):
        return func.attr
    if isinstance(func, ast.Name):
        return func.id
    return None


def _root_name(node) -> Optional[str]:
    while isinstance(node, ast.Attribute):
        node = node.value
    return node.id if isinstance(node, ast.Name) else None


def _shallow(node):
    """Child nodes of `node` without descending into nested function /
    lambda / class scopes (each nested scope is analyzed on its own)."""
    stack = list(ast.iter_child_nodes(node))
    while stack:
        n = stack.pop()
        yield n
        if not isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef,
                              ast.Lambda, ast.ClassDef)):
            stack.extend(ast.iter_child_nodes(n))


def _collect_params(node) -> Set[str]:
    a = node.args
    names = [p.arg for p in a.posonlyargs + a.args + a.kwonlyargs]
    if a.vararg:
        names.append(a.vararg.arg)
    if a.kwarg:
        names.append(a.kwarg.arg)
    return set(names)


def _build_scopes(tree: ast.Module) -> _Scope:
    module = _Scope(tree, "<module>", None, "module")

    def scan_body(scope: _Scope):
        for n in _shallow(scope.node):
            if isinstance(n, ast.Assign):
                for t in n.targets:
                    if isinstance(t, ast.Name):
                        scope.assign_values[t.id] = n.value
            elif isinstance(n, ast.Call):
                scope.calls.append(n)

    def build(node, scope: _Scope):
        for child in ast.iter_child_nodes(node):
            if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef,
                                  ast.Lambda)):
                name = getattr(child, "name", "<lambda>")
                s = _Scope(child, name, scope, "function")
                s.params = _collect_params(child)
                scan_body(s)
                build(child, s)
            elif isinstance(child, ast.ClassDef):
                build(child, _Scope(child, child.name, scope, "class"))
            else:
                build(child, scope)

    scan_body(module)
    build(tree, module)
    return module


def _all_scopes(scope: _Scope):
    yield scope
    for c in scope.children:
        yield from _all_scopes(c)


# ---------------------------------------------------------------------------
# R4 -- query-path parity (stale dyn view + guard resolution)
# ---------------------------------------------------------------------------


def _method_facts(cls_node: ast.ClassDef):
    facts = {}
    for item in cls_node.body:
        if not isinstance(item, (ast.FunctionDef, ast.AsyncFunctionDef)):
            continue
        self_calls: Set[str] = set()
        marks: Set[str] = set()
        for n in ast.walk(item):
            if not isinstance(n, ast.Call):
                continue
            f = n.func
            if isinstance(f, ast.Attribute):
                if isinstance(f.value, ast.Name) and f.value.id == "self":
                    self_calls.add(f.attr)
                    if f.attr in ("_check_dyn_view", "_ensure_dyn_view"):
                        marks.add("dyn_view")
                if (f.attr == "resolve" and isinstance(f.value, ast.Name)
                        and f.value.id == "GuardConfig"):
                    marks.add("guard_resolve")
        facts[item.name] = (item.lineno, self_calls, marks)
    return facts


def _reaches(facts, start: str, mark: str) -> bool:
    seen: Set[str] = set()
    stack = [start]
    while stack:
        m = stack.pop()
        if m in seen or m not in facts:
            continue
        seen.add(m)
        _, calls, marks = facts[m]
        if mark in marks:
            return True
        stack.extend(calls)
    return False


def _check_r4(module: _Scope, path: str, findings: List[Finding]) -> None:
    """R4 dyn-view-parity.  Every public `query*` entrypoint of a class
    that defines `_check_dyn_view` (worker/worker.py) must reach, through
    self-calls, both the stale-view check and `GuardConfig.resolve`; a
    serving class that defines `_ensure_dyn_view` (serve/session.py)
    must reach it from its `_dispatch` callback.  Otherwise a query
    computes on the pre-delta base graph while delta edges sit staged in
    the overlay, or an env-armed guard is ignored."""
    for s in _all_scopes(module):
        if s.kind != "class" or not isinstance(s.node, ast.ClassDef):
            continue
        facts = _method_facts(s.node)
        if "_check_dyn_view" in facts:
            for name, (lineno, _, _) in sorted(facts.items()):
                if not name.startswith("query"):
                    continue
                if not _reaches(facts, name, "dyn_view"):
                    findings.append(Finding(
                        "R4", path, lineno, f"{s.name}.{name}",
                        "public query entrypoint never reaches "
                        "_check_dyn_view — it would silently compute "
                        "on a stale dyn view",
                    ))
                if not _reaches(facts, name, "guard_resolve"):
                    findings.append(Finding(
                        "R4", path, lineno, f"{s.name}.{name}",
                        "public query entrypoint never resolves the "
                        "guard config (GuardConfig.resolve) — "
                        "env-armed guards would be silently ignored",
                    ))
        if "_ensure_dyn_view" in facts and "_dispatch" in facts:
            lineno = facts["_dispatch"][0]
            if not _reaches(facts, "_dispatch", "dyn_view"):
                findings.append(Finding(
                    "R4", path, lineno, f"{s.name}._dispatch",
                    "dispatch callback never reaches "
                    "_ensure_dyn_view — uncontracted apps would read "
                    "a stale dyn view",
                ))


# ---------------------------------------------------------------------------
# R5 -- eager logging + bool-in-numeric-schema
# ---------------------------------------------------------------------------


def _eager_msg(node) -> bool:
    if isinstance(node, ast.JoinedStr):
        return True
    if isinstance(node, ast.BinOp) and isinstance(node.op, (ast.Mod,
                                                           ast.Add)):
        # any + or % builds the string per call, "round " + str(r) too
        return True
    if isinstance(node, ast.Call):
        return (isinstance(node.func, ast.Attribute)
                and node.func.attr == "format")
    return False


def _check_r5(module: _Scope, path: str,
              findings: List[Finding]) -> None:
    """R5 eager-log / bool-in-numeric-schema.  A `vlog(level, msg)`
    whose message is formatted eagerly pays the formatting at disabled
    levels (utils/logging.py formats printf-style args only when the
    level prints); a validator (`valid|check|schema` in its name) that
    types numbers with `isinstance(x, int/float)` and never names `bool`
    accepts True as a number."""
    for s in _all_scopes(module):
        if s.kind == "class":
            continue
        for call in s.calls:
            if (_callee_base(call.func) == "vlog" and len(call.args) >= 2
                    and _eager_msg(call.args[1])):
                findings.append(Finding(
                    "R5", path, call.lineno, s.qualname,
                    "vlog message is formatted eagerly — pass "
                    "printf-style args so disabled levels pay "
                    "one int compare, not the formatting",
                ))

    module_tuples = {
        name: val for name, val in module.assign_values.items()
        if isinstance(val, ast.Tuple)
    }

    def numeric_classinfo(node) -> bool:
        if isinstance(node, ast.Name):
            if node.id in ("int", "float"):
                return True
            t = module_tuples.get(node.id)
            return t is not None and numeric_classinfo(t)
        if isinstance(node, ast.Tuple):
            return any(numeric_classinfo(e) for e in node.elts)
        return False

    for s in _all_scopes(module):
        if s.kind != "function" or not re.search(r"valid|check|schema",
                                                 s.name):
            continue
        if any(isinstance(n, ast.Name) and n.id == "bool"
               for n in ast.walk(s.node)):
            continue
        for n in ast.walk(s.node):
            if (isinstance(n, ast.Call)
                    and _callee_base(n.func) == "isinstance"
                    and len(n.args) == 2
                    and numeric_classinfo(n.args[1])):
                findings.append(Finding(
                    "R5", path, n.lineno, s.qualname,
                    "numeric schema check accepts bool — bool is an "
                    "int subclass; reject isinstance(x, bool) "
                    "explicitly",
                ))


# ---------------------------------------------------------------------------
# R6 -- pipelined-window carry reads vs the worker pipeline contract
# ---------------------------------------------------------------------------


def _window_contract():
    """The shipped pipeline contract (exact names + '*'-suffixed
    prefixes + audited whole-carry callees).  Imported from the
    runtime module rather than re-parsed: the contract IS the worker's
    declaration, and the lint must judge fixtures and the tree against
    the same set."""
    try:
        from libgrape_lite_tpu_torch.parallel.pipeline import (
            PIPELINE_WINDOW_CALLEES,
            PIPELINE_WINDOW_READS,
        )
    except Exception:  # pragma: no cover -- partial checkouts
        return frozenset(), (), frozenset()
    exact = frozenset(c for c in PIPELINE_WINDOW_READS
                      if not c.endswith("*"))
    prefixes = tuple(c[:-1] for c in PIPELINE_WINDOW_READS
                     if c.endswith("*"))
    return exact, prefixes, frozenset(PIPELINE_WINDOW_CALLEES)


def _check_r6(module: _Scope, path: str, findings: List[Finding]) -> None:
    """R6 pipeline-window-read.  The double-buffered superstep pipeline
    (parallel/pipeline.py) kicks off the next round's exchange on a side
    stream mid-round and overlaps the interior pull with it.  Every read of the query carry inside that window is
    only safe because the kickoff writes a fresh buffer and never
    aliases live state; each must be audited against the worker
    pipeline contract.  Audited forms:

    * a constant-keyed subscript of a carry-dict parameter after the
      kickoff line, or a load of a variable bound from one BEFORE the
      kickoff — the key must be named in PIPELINE_WINDOW_READS;
    * the WHOLE carry dict passed as a call argument after the kickoff
      (R6 cannot see the callee's body) — the callee must be named in
      PIPELINE_WINDOW_CALLEES;
    * reads inside a NESTED function that captures the carry dict —
      audited position-independently (its call time is unknowable
      statically), same two rules.

    An unnamed read is the aliasing bug class the double buffering
    exists to prevent, fossilized before it can ship (zero-entry
    baseline).  "Carry-dict parameter" = a parameter subscripted with
    a string constant anywhere in the function (frag/ctx params never
    are, so they don't trip the escape rule)."""
    exact, prefixes, callees = _window_contract()

    def named(key: str) -> bool:
        return key in exact or (
            bool(prefixes) and key.startswith(prefixes)
        )

    def callee_of(call: ast.Call):
        f = call.func
        if isinstance(f, ast.Attribute):
            return f.attr
        if isinstance(f, ast.Name):
            return f.id
        return None

    for s in _all_scopes(module):
        if s.kind != "function":
            continue
        kick_line = None
        for n in _shallow(s.node):
            if (
                isinstance(n, ast.Call)
                and isinstance(n.func, ast.Attribute)
                and n.func.attr == "kickoff"
            ):
                kick_line = (
                    n.lineno if kick_line is None
                    else min(kick_line, n.lineno)
                )
        if kick_line is None:
            continue
        # parameters actually USED as carry dicts: subscripted with a
        # string constant somewhere in the function (incl. nested)
        dict_params: Set[str] = set()
        for n in ast.walk(s.node):
            if (
                isinstance(n, ast.Subscript)
                and isinstance(n.value, ast.Name)
                and n.value.id in s.params
                and isinstance(n.slice, ast.Constant)
                and isinstance(n.slice.value, str)
            ):
                dict_params.add(n.value.id)
        # carry aliases bound before the kickoff: x = state["key"]
        aliases: Dict[str, str] = {}
        for n in _shallow(s.node):
            if (
                isinstance(n, ast.Assign)
                and getattr(n, "lineno", 0) <= kick_line
                and isinstance(n.value, ast.Subscript)
                and isinstance(n.value.value, ast.Name)
                and n.value.value.id in s.params
                and isinstance(n.value.slice, ast.Constant)
                and isinstance(n.value.slice.value, str)
            ):
                for t in n.targets:
                    if isinstance(t, ast.Name):
                        aliases[t.id] = n.value.slice.value
        seen: Set[str] = set()

        def flag(key: str, line: int, what: str) -> None:
            if key in seen:
                return
            seen.add(key)
            findings.append(Finding(
                "R6", path, line, s.qualname,
                f"{what} inside the pipelined window (after the "
                "exchange kickoff) is not named in the worker "
                "pipeline contract (parallel/pipeline."
                "PIPELINE_WINDOW_READS / PIPELINE_WINDOW_CALLEES) -- "
                "audit it as double-buffer-safe and declare it, or "
                "move the read before the kickoff",
            ))

        def check_nodes(nodes, in_window, params) -> None:
            for n in nodes:
                post = in_window(n)
                if (
                    post
                    and isinstance(n, ast.Subscript)
                    and isinstance(n.ctx, ast.Load)
                    and isinstance(n.value, ast.Name)
                    and n.value.id in params
                    and isinstance(n.slice, ast.Constant)
                    and isinstance(n.slice.value, str)
                    and not named(n.slice.value)
                ):
                    flag(n.slice.value, n.lineno,
                         f"carry read {n.slice.value!r}")
                elif (
                    post
                    and isinstance(n, ast.Name)
                    and isinstance(n.ctx, ast.Load)
                    and n.id in aliases
                    and not named(aliases[n.id])
                ):
                    flag(aliases[n.id], n.lineno,
                         f"carry read {aliases[n.id]!r} (via alias "
                         f"{n.id!r})")
                elif post and isinstance(n, ast.Call):
                    cn = callee_of(n)
                    if cn in callees:
                        continue
                    args = list(n.args) + [k.value for k in n.keywords]
                    for a in args:
                        if (
                            isinstance(a, ast.Name)
                            and a.id in params
                            and a.id in dict_params
                        ):
                            flag(f"<{a.id} -> {cn}()>", n.lineno,
                                 f"whole carry dict {a.id!r} passed "
                                 f"to unaudited callee {cn!r}")

        # (1) the kickoff function's own body, after the kickoff line
        check_nodes(
            _shallow(s.node),
            lambda n: getattr(n, "lineno", 0) > kick_line,
            s.params,
        )
        # (2) nested functions capturing a carry dict: call time is
        # unknowable, so every read is window-audited (a nested def
        # re-binding the name as its own param shadows it — own scope)
        for child in s.children:
            if child.kind != "function":
                continue
            free = dict_params - child.params
            if not free:
                continue
            check_nodes(
                (n for n in ast.walk(child.node)
                 if not isinstance(n, (ast.FunctionDef,
                                       ast.AsyncFunctionDef))),
                lambda n: True,
                free,
            )


# ---------------------------------------------------------------------------
# R7 -- host syncs on the async pump's dispatch stage
# ---------------------------------------------------------------------------

_R7_PATH_RE = re.compile(r"(^|/)serve/pipeline\.py$")
_R7_DISPATCH_RE = re.compile(r"^_?(dispatch|fill)")


def _pump_harvest_contract():
    """The pump module's own declaration of which methods may force a
    host sync (serve/pipeline.PUMP_HARVEST_SYNCS), imported so the lint
    judges fixtures and the tree against one set."""
    try:
        from libgrape_lite_tpu_torch.serve.pipeline import (
            PUMP_HARVEST_SYNCS,
        )
    except Exception:  # pragma: no cover -- a partial checkout
        return frozenset()
    return frozenset(PUMP_HARVEST_SYNCS)


def _r7_sync_forcer(call: ast.Call) -> Optional[str]:
    """A tag when `call` forces a host sync, else None: the JAX rule's
    set (block_until_ready / device_get, np.asarray, .item() / .tolist(),
    int() / float() on a non-literal) plus PyTorch's copies to the host
    (.cpu(), .numpy()) and waits on the card (torch.cuda.synchronize(),
    .synchronize() on an event or a stream)."""
    base = _callee_base(call.func)
    attr = isinstance(call.func, ast.Attribute)
    if base in ("block_until_ready", "device_get"):
        return f"{base}()"
    if (base == "asarray" and attr
            and _root_name(call.func) in _ARRAY_MODULES):
        return "asarray() (materialises the device buffer)"
    if (isinstance(call.func, ast.Name) and base in ("int", "float")
            and call.args and not isinstance(call.args[0], ast.Constant)):
        return f"{base}() on a non-literal value"
    if base in ("item", "tolist") and attr:
        return f".{base}()"
    if base in ("cpu", "numpy") and attr:
        return f".{base}() (copies the tensor to the host)"
    if base == "synchronize" and attr:
        return "synchronize() (waits on the card)"
    return None


def _check_r7(module: _Scope, path: str, findings: List[Finding]) -> None:
    """R7 sync-in-pump.  The async pump's dispatch stage
    (serve/pipeline.py `_fill*` / `_dispatch*` self-call chains) keeps a
    window of batches in flight; one host sync on it re-serialises the
    window.  The pump names its harvest-side methods in
    `PUMP_HARVEST_SYNCS`; this rule walks every self-call chain rooted at
    a dispatch-stage method, stops at contract names, and flags any sync
    forcer it reaches.  Nested functions are skipped: a thunk built at
    dispatch time runs at harvest time.  Path-scoped to
    serve/pipeline.py: the synchronous session and queue may sync.  A
    sync inside a callee in another module (`Worker.query_batch_prepare`)
    is out of the rule's sight; chip_smoke.py's `[lint]` phase counts
    those on the card."""
    if not _R7_PATH_RE.search(path):
        return
    contract = _pump_harvest_contract()

    def scan(fs: _Scope, owner: str) -> None:
        for n in _shallow(fs.node):
            if isinstance(n, ast.Call):
                what = _r7_sync_forcer(n)
                if what is not None:
                    findings.append(Finding(
                        "R7", path, n.lineno, owner,
                        f"{what} reached from the pump's dispatch "
                        "stage outside the audited harvest contract "
                        "(serve/pipeline.PUMP_HARVEST_SYNCS) — one "
                        "stray sync re-serialises the dispatch "
                        "window; move it to the harvest stage or "
                        "audit and name the method in the contract",
                    ))

    for s in _all_scopes(module):
        if s.kind == "class" and isinstance(s.node, ast.ClassDef):
            facts = _method_facts(s.node)
            roots = [m for m in facts
                     if _R7_DISPATCH_RE.match(m) and m not in contract]
            if not roots:
                continue
            seen: Set[str] = set()
            stack = list(roots)
            while stack:
                m = stack.pop()
                if m in seen or m in contract or m not in facts:
                    continue
                seen.add(m)
                stack.extend(c for c in facts[m][1] if c not in contract)
            scopes = {c.name: c for c in s.children if c.kind == "function"}
            for name in sorted(seen):
                fs = scopes.get(name)
                if fs is not None:
                    scan(fs, f"{s.name}.{name}")
        elif (s.kind == "function" and s.parent is not None
              and s.parent.kind == "module"
              and _R7_DISPATCH_RE.match(s.name)
              and s.name not in contract):
            scan(s, s.qualname)


# ---------------------------------------------------------------------------
# R8 -- module-level *_STATS surfaces outside the stats federation
# ---------------------------------------------------------------------------

_R8_NAME_RE = re.compile(r"^[A-Za-z_][A-Za-z0-9_]*_STATS$")
_R8_FED_MODULE = f"{_PACKAGE}.obs.federation"
_R8_OBS_MODULE = f"{_PACKAGE}.obs"


def _r8_federation_names(tree: ast.Module):
    """Names under which this module can reach the federation: (module
    aliases of obs.federation / obs, direct `register` names, direct
    `FederatedStats` constructor names).  Function-level imports count."""
    mod_aliases: Set[str] = set()
    reg_names: Set[str] = set()
    ctor_names: Set[str] = set()
    for n in ast.walk(tree):
        if isinstance(n, ast.ImportFrom):
            if n.module == _R8_FED_MODULE:
                for a in n.names:
                    bound = a.asname or a.name
                    if a.name == "register":
                        reg_names.add(bound)
                    elif a.name == "FederatedStats":
                        ctor_names.add(bound)
            elif n.module == _R8_OBS_MODULE:
                for a in n.names:
                    bound = a.asname or a.name
                    if a.name == "federation":
                        mod_aliases.add(bound)
                    elif a.name == "FederatedStats":
                        ctor_names.add(bound)
        elif isinstance(n, ast.Import):
            for a in n.names:
                if a.name == _R8_FED_MODULE:
                    mod_aliases.add(a.asname or _PACKAGE)
    return mod_aliases, reg_names, ctor_names


def _check_r8(module: _Scope, path: str,
              findings: List[Finding]) -> None:
    """R8 unfederated-stats.  A module-level ``*_STATS`` assignment
    declares an operational ledger, and the stats federation
    (obs/federation.py) is the registry it must join so that one
    ``snapshot()`` -- the live exporter and every postmortem bundle --
    sees it.  A surface passes when its value is constructed as
    ``FederatedStats(...)``, or when the module calls ``federation.register(...)`` anywhere.  obs/federation.py
    itself is exempt."""
    if path.endswith("obs/federation.py"):
        return
    tree = module.node
    mod_aliases, reg_names, ctor_names = _r8_federation_names(tree)

    def registers(call: ast.Call) -> bool:
        f = call.func
        if isinstance(f, ast.Name) and f.id in reg_names:
            return True
        return (isinstance(f, ast.Attribute) and f.attr == "register"
                and _root_name(f) in mod_aliases)

    if any(isinstance(n, ast.Call) and registers(n) for n in ast.walk(tree)):
        return
    for stmt in tree.body:
        if isinstance(stmt, ast.Assign):
            targets, value = stmt.targets, stmt.value
        elif isinstance(stmt, ast.AnnAssign) and stmt.value is not None:
            targets, value = [stmt.target], stmt.value
        else:
            continue
        names = [t.id for t in targets
                 if isinstance(t, ast.Name) and _R8_NAME_RE.match(t.id)]
        if not names:
            continue
        if (isinstance(value, ast.Call)
                and _callee_base(value.func) in ctor_names):
            continue
        for name in names:
            findings.append(Finding(
                "R8", path, stmt.lineno, name,
                f"module-level stats surface {name} is not in the "
                "stats federation — construct it as "
                "obs.federation.FederatedStats or call "
                "federation.register(namespace, snapshot, reset) in "
                "this module, so federation.snapshot(), the live "
                "/metrics exporter, and postmortem bundles can see it",
            ))


# ---------------------------------------------------------------------------
# R9 -- result-cache key completeness
# ---------------------------------------------------------------------------

#: autopilot/cache.py's CACHE_KEY_FIELDS with the synonyms a call site may
#: spell each with: the fence is an ingest epoch on a bare session and a
#: version on a replica
_R9_KEY_FIELDS = (
    ("compat", ("compat",)),
    ("source", ("source",)),
    ("fence", ("fence", "epoch", "version")),
)
_R9_CACHE_METHODS = {"lookup", "store"}


def _r9_idents(node: ast.AST) -> Set[str]:
    """Every identifier-ish token an argument expression names: Name
    ids, Attribute attrs and string constants."""
    out: Set[str] = set()
    for n in ast.walk(node):
        if isinstance(n, ast.Name):
            out.add(n.id)
        elif isinstance(n, ast.Attribute):
            out.add(n.attr)
        elif isinstance(n, ast.Constant) and isinstance(n.value, str):
            out.add(n.value)
    return out


def _check_r9(module: _Scope, path: str,
              findings: List[Finding]) -> None:
    """R9 cache-key-completeness.  A `.lookup(...)` / `.store(...)` call
    whose receiver chain names a cache is a result-cache call site; its
    arguments must name every field of the result identity (compat key,
    lane source, fence epoch), or two different queries or two graph
    versions could share one cached answer.  A starred argument names
    nothing.  autopilot/cache.py itself is exempt."""
    if path.endswith("autopilot/cache.py"):
        return
    for n in ast.walk(module.node):
        if not isinstance(n, ast.Call):
            continue
        f = n.func
        if not (isinstance(f, ast.Attribute)
                and f.attr in _R9_CACHE_METHODS):
            continue
        chain = []
        v = f.value
        while isinstance(v, ast.Attribute):
            chain.append(v.attr)
            v = v.value
        if isinstance(v, ast.Name):
            chain.append(v.id)
        if not any("cache" in part.lower() for part in chain):
            continue
        idents: Set[str] = set()
        for a in n.args:
            idents |= _r9_idents(a)
        for kw in n.keywords:
            if kw.arg:
                idents.add(kw.arg)
            idents |= _r9_idents(kw.value)
        lowered = {i.lower() for i in idents}
        missing = [fld for fld, synonyms in _R9_KEY_FIELDS
                   if not any(s in tok for s in synonyms for tok in lowered)]
        if missing:
            findings.append(Finding(
                "R9", path, n.lineno, f.attr,
                f"result-cache {f.attr}() does not name the full "
                f"result identity — missing {', '.join(missing)}: "
                "every lookup/store must carry every compat_key "
                "field plus the lane source and the fence epoch "
                "(autopilot/cache.py CACHE_KEY_FIELDS), or a stale "
                "or structurally different answer can be served as "
                "a hit",
            ))


# ---------------------------------------------------------------------------
# R10 -- pricing rates pinned outside ops/calibration.py
# ---------------------------------------------------------------------------

#: module-level names that declare a pricing RATE.  Op-count conventions
#: (DEFAULT_OPS_PER_EDGE, stage heights) are not rates
_R10_NAME_RE = re.compile(
    r"(_BPS|_HZ|_CYC_PER_ELEM|_PER_CYCLE|_ROWS_PER_CYCLE)$"
    r"|^_?GATHER_RATES$"
)


def _r10_literal_number(value: ast.AST) -> bool:
    """True when `value` is (or, for a dict table, holds) a numeric
    literal; reading the profile (`default_profile().hbm_bps`) is not."""
    if isinstance(value, ast.Constant):
        return (isinstance(value.value, (int, float))
                and not isinstance(value.value, bool))
    if isinstance(value, ast.BinOp):
        return (_r10_literal_number(value.left)
                and _r10_literal_number(value.right))
    if isinstance(value, ast.UnaryOp):
        return _r10_literal_number(value.operand)
    if isinstance(value, ast.Dict):
        return any(_r10_literal_number(v) for v in value.values)
    return False


def _check_r10(module: _Scope, path: str,
               findings: List[Finding]) -> None:
    """R10 pinned-rate-constant.  A module-level rate name (``*_BPS``,
    ``*_HZ``, ``*_CYC_PER_ELEM``, ``*_PER_CYCLE``, a ``GATHER_RATES``
    table) bound to a numeric literal outside ops/calibration.py is a
    private rate copy the calibration fit cannot update and the drift
    gate cannot see.  Reading the shared profile passes."""
    if path.endswith("ops/calibration.py"):
        return
    for stmt in module.node.body:
        if isinstance(stmt, ast.Assign):
            targets, value = stmt.targets, stmt.value
        elif isinstance(stmt, ast.AnnAssign) and stmt.value is not None:
            targets, value = [stmt.target], stmt.value
        else:
            continue
        names = [t.id for t in targets
                 if isinstance(t, ast.Name) and _R10_NAME_RE.search(t.id)]
        if not names or not _r10_literal_number(value):
            continue
        for name in names:
            findings.append(Finding(
                "R10", path, stmt.lineno, name,
                f"pricing rate {name} is pinned as a numeric literal "
                "outside ops/calibration.py — a private copy the "
                "calibration fit cannot update and the drift gate "
                "cannot audit; read it from the shared RateProfile "
                "(ops/calibration.default_profile / active_profile) "
                "instead",
            ))


# ---------------------------------------------------------------------------
# R11 -- raw mesh axis names in models/
# ---------------------------------------------------------------------------

#: the sanctioned spellings of the vertex cut's mesh axis names -- the
#: string values of parallel/comm_spec.VC_ROW_AXIS / VC_COL_AXIS.  Inlined
#: (not imported) on purpose: the lint must keep flagging the raw strings
#: even if the runtime constants are renamed out from under the literal
#: copies it hunts.
_R11_AXIS_LITERALS = ("vcrow", "vccol")


def _check_r11(module: _Scope, path: str,
               findings: List[Finding]) -> None:
    """R11 raw-axis-name.  A models/ module that spells a mesh axis name
    of the vertex cut as a raw string literal ('vcrow' / 'vccol') holds a
    private copy of the grid contract: every reduction over a row- or
    column-axis group is only correct because its axis name matches
    parallel/comm_spec.py's, and a renamed or extended grid would miss
    the literal silently -- a collective over the wrong group, not an
    import error.  Importing VC_ROW_AXIS / VC_COL_AXIS from
    parallel/comm_spec.py is the sanctioned form (the defining module
    itself, and layers outside models/, are out of scope)."""
    if "/models/" not in "/" + path:
        return
    for n in ast.walk(module.node):
        if (isinstance(n, ast.Constant) and isinstance(n.value, str)
                and n.value in _R11_AXIS_LITERALS):
            findings.append(Finding(
                "R11", path, n.lineno, "<module>",
                f"raw mesh axis name {n.value!r} in models/ -- a private "
                "copy of the grid contract; import VC_ROW_AXIS/"
                "VC_COL_AXIS from parallel/comm_spec.py so a rename is an "
                "import error instead of a collective over the wrong "
                "group",
            ))


# ---------------------------------------------------------------------------
# R12 -- modeled claims must carry a join key
# ---------------------------------------------------------------------------

#: a dict key that states a modeled overlap claim
_R12_MODELED_RE = re.compile(r"^(modeled_|hidden_us)")
#: the correlation keys a measured wait joins on
_R12_JOIN_KEYS = ("plan_uid", "trace_key")


def _r12_scopes(tree: ast.AST):
    """Module + every function def, each walked without descending into
    nested function bodies (those are their own scopes)."""
    def shallow(node):
        for c in ast.iter_child_nodes(node):
            if isinstance(c, (ast.FunctionDef, ast.AsyncFunctionDef)):
                continue
            yield c
            yield from shallow(c)

    for n in ast.walk(tree):
        if isinstance(n, (ast.Module, ast.FunctionDef,
                          ast.AsyncFunctionDef)):
            yield n, list(shallow(n))


def _r12_str_keys(d: ast.Dict):
    return {k.value for k in d.keys
            if isinstance(k, ast.Constant) and isinstance(k.value, str)}


def _r12_claims(keys) -> bool:
    return ("engaged" in keys
            and any(_R12_MODELED_RE.match(k) for k in keys)
            and not any(j in keys for j in _R12_JOIN_KEYS))


def _check_r12(module: _Scope, path: str,
               findings: List[Finding]) -> None:
    """R12 unkeyed-modeled-claim.  A dict that carries a modeled overlap
    claim (``modeled_*`` / ``hidden_us*``) next to an ``engaged`` verdict
    is a decision record whose claim can only be checked against measured
    waits through a ``plan_uid`` / ``trace_key`` in the same record.
    Audited per scope: a dict literal holding the keys inline, and a name
    bound to a dict literal grown by later subscript assignments."""
    for _, nodes in _r12_scopes(module.node):
        literal_of: dict = {}
        keys_of: dict = {}
        first_line: dict = {}
        bound_literals: set = set()
        for n in nodes:
            if isinstance(n, ast.Assign) and isinstance(n.value, ast.Dict):
                for t in n.targets:
                    if isinstance(t, ast.Name):
                        literal_of[t.id] = n
                        keys_of.setdefault(t.id, set()).update(
                            _r12_str_keys(n.value))
                        first_line.setdefault(t.id, n.lineno)
                        # judged by the key union below, where a later
                        # subscript may supply the join key
                        bound_literals.add(id(n.value))
            elif isinstance(n, ast.Dict) and id(n) not in bound_literals:
                if _r12_claims(_r12_str_keys(n)):
                    findings.append(Finding(
                        "R12", path, n.lineno, "<dict>",
                        "modeled overlap claim next to an `engaged` "
                        "verdict without a plan_uid/trace_key — the "
                        "overlap truth meter cannot join this record "
                        "against measured device waits; stamp the "
                        "plan uid into the same dict",
                    ))
            elif (isinstance(n, ast.Assign) and len(n.targets) == 1
                  and isinstance(n.targets[0], ast.Subscript)
                  and isinstance(n.targets[0].value, ast.Name)
                  and isinstance(n.targets[0].slice, ast.Constant)
                  and isinstance(n.targets[0].slice.value, str)):
                keys_of.setdefault(n.targets[0].value.id, set()).add(
                    n.targets[0].slice.value)
        for name in literal_of:
            if _r12_claims(keys_of.get(name, set())):
                findings.append(Finding(
                    "R12", path, first_line[name], name,
                    f"decision record {name!r} claims modeled overlap "
                    "(modeled_*/hidden_us* key) next to `engaged` but "
                    "never stamps plan_uid/trace_key in this scope — "
                    "the truth meter cannot join the claim against "
                    "measured device waits",
                ))


# ---------------------------------------------------------------------------
# entry points
# ---------------------------------------------------------------------------

_CHECKS = (_check_r4, _check_r5, _check_r6, _check_r7, _check_r8,
           _check_r9, _check_r10, _check_r11, _check_r12)


def lint_source(src: str, relpath: str) -> List[Finding]:
    """Every carried rule's findings for one module's source text."""
    relpath = relpath.replace(os.sep, "/")
    try:
        tree = ast.parse(src)
    except SyntaxError as e:
        return [Finding("E0", relpath, e.lineno or 0, "<module>",
                        f"syntax error: {e.msg}")]
    module = _build_scopes(tree)
    findings: List[Finding] = []
    for check in _CHECKS:
        check(module, relpath, findings)
    return findings


_SKIP_DIRS = {"__pycache__", "scratch", ".git", ".pytest_cache",
              "node_modules"}


def iter_py_files(path: str):
    if os.path.isfile(path):
        yield path
        return
    if not os.path.isdir(path):
        # a mistyped path fails the gate instead of linting nothing
        raise FileNotFoundError(f"lint path does not exist: {path!r}")
    for dirpath, dirnames, filenames in os.walk(path):
        dirnames[:] = [d for d in sorted(dirnames) if d not in _SKIP_DIRS]
        for fn in sorted(filenames):
            if fn.endswith(".py"):
                yield os.path.join(dirpath, fn)


def lint_paths(paths, root: Optional[str] = None) -> List[Finding]:
    """Findings over files and trees; paths in findings are relative to
    `root` (default: the repo root), so fingerprints do not depend on the
    invocation directory."""
    if root is None:
        root = repo_root()
    findings: List[Finding] = []
    for p in paths:
        for f in iter_py_files(p):
            rel = os.path.relpath(os.path.abspath(f), root)
            with open(f, encoding="utf-8") as fh:
                findings.extend(lint_source(fh.read(), rel))
    return findings


def repo_root() -> str:
    """The directory holding the libgrape_lite_tpu_torch package."""
    return os.path.dirname(
        os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
