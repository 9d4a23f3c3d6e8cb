"""R6 ``lock-order``: whole-program lock-acquisition graph analysis.

The port's copy of ``celestia_tpu/lint/lockorder.py``: it derives the
hierarchy over ``celestia_tpu_torch`` and holds it against
``specs/lock_hierarchy_torch.md`` (the JAX package's stays in
``specs/lock_hierarchy.md``).

The node's growth multiplied the lock population (LruCache registry + per-cache
locks, BreakerRegistry, the telemetry/tracing/timeseries rings, devprof,
the faults registry) and nothing stops an innocent edit from acquiring
two of them in the order OPPOSITE to some other thread's — the classic
cross-module deadlock that no single-file rule can see.  This pass
builds ONE directed graph over every lock in the package and fails on
any cycle.

**Lock discovery.**  A lock node is created for every

* assignment of ``threading.Lock()`` / ``threading.RLock()`` to a module
  global (``_lock = threading.Lock()`` → ``utils/faults.py::_lock``) or
  a ``self`` attribute inside a class (``self._lock = threading.Lock()``
  → ``utils/lru.py::LruCache.self._lock``);
* lock expression named by a ``# celint: guarded-by(<lock>)`` directive
  (annotation-only locks: state guarded by a lock that is created
  dynamically or in another scope still participates in ordering).

Instance locks are identified per CLASS, not per object: two LruCache
instances share one node.  That is deliberately conservative — a
cross-instance AB/BA order on the same class is reported even though a
disjoint pair of instances cannot deadlock, because nothing in the
source proves the instances ARE disjoint.

**Edge construction.**

* Lexical nesting: ``with A:`` containing ``with B:`` adds A → B.
* Call-mediated: a call made while lexically holding A, resolved to a
  function in the package whose transitive may-acquire set contains B,
  adds A → B.  Calls resolve intra-package only: same-module functions,
  ``self.method()`` on the enclosing class, ``<imported module>.fn()``
  through ``celestia_tpu_torch`` imports, and attribute calls whose method
  name is defined by exactly ONE class in the program (unique-name
  resolution; ambiguous names are skipped — missing an edge is a known
  cost, inventing one is a false positive).
* ``*_locked`` convention: a function named ``*_locked`` is analyzed as
  if its own class/module locks are held at entry (the suffix is the
  repo's caller-holds-the-lock contract), so an acquisition inside it
  becomes an edge from the assumed-held lock.

**Findings.**

* Any cycle in the graph (potential deadlock) — the message carries the
  full acquisition chain with the file:line of every edge.
* A self-edge on a non-reentrant ``threading.Lock`` (A acquired while A
  is held): not an ordering bug but an immediate self-deadlock.
* Drift between the derived hierarchy and ``specs/lock_hierarchy_torch.md``
  (full-tree runs only): the committed doc must always match the code.
  Regenerate with ``python -m celestia_tpu_torch.lint --write-lock-hierarchy``.

The derived graph is also the static half of the runtime shadow checker
(utils/lockwatch.py): :func:`lock_decl_sites` maps source declaration
sites to lock ids so lockwatch's observed acquisition pairs can be
cross-checked against this graph (:func:`runtime_crosscheck`).
"""

from __future__ import annotations

import ast
from dataclasses import dataclass, field
from pathlib import Path
from typing import Dict, Iterator, List, Optional, Set, Tuple

from celestia_tpu_torch.lint.engine import (
    Finding,
    ModuleContext,
    Program,
    ProgramRule,
    REPO_ROOT,
    normalize_expr,
    register,
)

HIERARCHY_PATH = "specs/lock_hierarchy_torch.md"
REGEN_CMD = "python -m celestia_tpu_torch.lint --write-lock-hierarchy"

_LOCK_CTORS = {"Lock": "lock", "RLock": "rlock", "Condition": "condition"}


@dataclass
class LockInfo:
    lock_id: str  # "<relpath>::<name>" or "<relpath>::<Class>.self.<attr>"
    relpath: str
    line: int
    kind: str  # lock | rlock | condition | annotation


@dataclass
class _Call:
    line: int
    held: Tuple[str, ...]  # lock ids held at the call site
    # resolution candidates, tried in order: ("func", module, name),
    # ("method", module, class, name), ("unique", name)
    keys: Tuple[Tuple, ...]


@dataclass
class _FuncInfo:
    qualname: str  # "<relpath>::<Class.>name"
    relpath: str
    cls: Optional[str]
    name: str
    acquires: List[Tuple[str, int]] = field(default_factory=list)
    edges: List[Tuple[str, str, int]] = field(default_factory=list)
    calls: List[_Call] = field(default_factory=list)
    # transitive may-acquire: lock id -> witness (qualname, line) of the
    # acquisition this function can reach
    may_acquire: Dict[str, Tuple[str, int]] = field(default_factory=dict)


class _ModuleFacts:
    """Per-module lock/function/import facts feeding the program graph.
    ``known_paths`` is the set of relpaths IN the program, so import
    resolution works for fixture modules that exist only in memory."""

    def __init__(self, ctx: ModuleContext, known_paths: Optional[Set[str]] = None):
        self.ctx = ctx
        self.known_paths = known_paths or set()
        self.relpath = ctx.relpath
        self.threading_aliases: Set[str] = set()
        self.ctor_aliases: Dict[str, str] = {}  # bare name -> kind
        self.module_imports: Dict[str, str] = {}  # local alias -> relpath
        self.func_imports: Dict[str, Tuple[str, str]] = {}  # name -> (relpath, fn)
        self.locks: Dict[str, LockInfo] = {}  # lock_id -> info
        self.module_lock_names: Dict[str, str] = {}  # global name -> lock_id
        # class -> {self attr -> lock_id}
        self.class_lock_attrs: Dict[str, Dict[str, str]] = {}
        self.functions: Dict[str, _FuncInfo] = {}
        self._collect_imports()
        self._collect_locks()

    # -- imports -------------------------------------------------------

    def _collect_imports(self) -> None:
        for node in ast.walk(self.ctx.tree):
            if isinstance(node, ast.Import):
                for a in node.names:
                    if a.name == "threading":
                        self.threading_aliases.add(a.asname or "threading")
                    elif a.name.startswith("celestia_tpu_torch."):
                        if a.asname is not None:
                            target = self._mod_relpath(a.name)
                            if target is not None:
                                self.module_imports[a.asname] = target
            elif isinstance(node, ast.ImportFrom):
                if node.module == "threading":
                    for a in node.names:
                        if a.name in _LOCK_CTORS:
                            self.ctor_aliases[a.asname or a.name] = (
                                _LOCK_CTORS[a.name]
                            )
                elif node.module and node.module.startswith("celestia_tpu_torch"):
                    for a in node.names:
                        local = a.asname or a.name
                        sub = self._mod_relpath(f"{node.module}.{a.name}")
                        if sub is not None:
                            # "from celestia_tpu_torch.utils import faults"
                            self.module_imports[local] = sub
                        else:
                            owner = self._mod_relpath(node.module)
                            if owner is not None:
                                self.func_imports[local] = (owner, a.name)

    def _mod_relpath(self, dotted: str) -> Optional[str]:
        """repo-relative path of a celestia_tpu_torch dotted module — resolved
        against the program's own files FIRST (fixtures exist only in
        memory), the working tree second.  None when the dotted name is
        not a module (then it was a from-import of a function/class)."""
        if not dotted.startswith("celestia_tpu_torch"):
            return None
        rel = dotted.replace(".", "/")
        if rel + ".py" in self.known_paths:
            return rel + ".py"
        if rel + "/__init__.py" in self.known_paths:
            return rel + "/__init__.py"
        if (REPO_ROOT / (rel + ".py")).is_file():
            return rel + ".py"
        if (REPO_ROOT / rel / "__init__.py").is_file():
            return rel + "/__init__.py"
        return None

    # -- lock discovery ------------------------------------------------

    def _lock_kind_of_call(self, node: ast.AST) -> Optional[str]:
        if not isinstance(node, ast.Call):
            return None
        f = node.func
        if isinstance(f, ast.Attribute) and isinstance(f.value, ast.Name):
            if f.value.id in self.threading_aliases and f.attr in _LOCK_CTORS:
                return _LOCK_CTORS[f.attr]
        elif isinstance(f, ast.Name) and f.id in self.ctor_aliases:
            return self.ctor_aliases[f.id]
        return None

    def _enclosing_class(self, node: ast.AST) -> Optional[str]:
        for anc in self.ctx.ancestors(node):
            if isinstance(anc, ast.ClassDef):
                return anc.name
            if isinstance(anc, ast.Module):
                break
        return None

    def _add_lock(
        self, name: str, cls: Optional[str], line: int, kind: str
    ) -> str:
        if cls is not None:
            lock_id = f"{self.relpath}::{cls}.self.{name}"
            self.class_lock_attrs.setdefault(cls, {})[name] = lock_id
        else:
            lock_id = f"{self.relpath}::{name}"
            self.module_lock_names[name] = lock_id
        if lock_id not in self.locks or self.locks[lock_id].kind == "annotation":
            self.locks[lock_id] = LockInfo(lock_id, self.relpath, line, kind)
        return lock_id

    def _collect_locks(self) -> None:
        for node in ast.walk(self.ctx.tree):
            if not isinstance(node, (ast.Assign, ast.AnnAssign)):
                continue
            value = node.value
            kind = self._lock_kind_of_call(value)
            if kind is None:
                continue
            targets = (
                node.targets if isinstance(node, ast.Assign) else [node.target]
            )
            for t in targets:
                if isinstance(t, ast.Name):
                    cls = self._enclosing_class(node)
                    # a Lock() assigned to a plain name inside a class
                    # body is a class attribute; inside a function it is
                    # a local — both are scoped to best effort
                    self._add_lock(t.id, cls, node.lineno, kind)
                elif (
                    isinstance(t, ast.Attribute)
                    and isinstance(t.value, ast.Name)
                    and t.value.id == "self"
                ):
                    cls = self._enclosing_class(node)
                    if cls is not None:
                        self._add_lock(t.attr, cls, node.lineno, kind)
        # annotation-only locks: guarded-by(<expr>) registers the lock
        # even when its construction is out of scope
        for g in self.ctx.guards:
            self._resolve_guard_lock(g.lock, g.target_line)

    def _resolve_guard_lock(self, expr: str, line: int) -> None:
        expr = normalize_expr(expr)
        if expr.startswith("self."):
            attr = expr[len("self."):]
            node = self._node_at_line(line)
            cls = self._enclosing_class(node) if node is not None else None
            if cls is not None and attr not in self.class_lock_attrs.get(cls, {}):
                self._add_lock(attr, cls, line, "annotation")
        elif "." not in expr and "(" not in expr:
            if expr not in self.module_lock_names:
                self._add_lock(expr, None, line, "annotation")

    def _node_at_line(self, line: int) -> Optional[ast.AST]:
        for node in ast.walk(self.ctx.tree):
            if getattr(node, "lineno", None) == line:
                return node
        return None

    # -- with-expression resolution -------------------------------------

    def resolve_lock_expr(self, expr: ast.AST, cls: Optional[str]) -> Optional[str]:
        """Lock id a ``with`` context expression refers to, or None."""
        if isinstance(expr, ast.Name):
            return self.module_lock_names.get(expr.id)
        if isinstance(expr, ast.Attribute):
            base = expr.value
            if isinstance(base, ast.Name):
                if base.id == "self" and cls is not None:
                    return self.class_lock_attrs.get(cls, {}).get(expr.attr)
                target = self.module_imports.get(base.id)
                if target is not None:
                    # with faults._lock: — cross-module module-level lock
                    return f"{target}::{expr.attr}"
        return None


# ---------------------------------------------------------------------------
# function analysis
# ---------------------------------------------------------------------------


def _analyze_functions(facts: _ModuleFacts) -> None:
    ctx = facts.ctx

    def walk_nodes(
        fn: _FuncInfo,
        nodes: List[ast.AST],
        held: Tuple[str, ...],
        cls: Optional[str],
    ) -> None:
        for child in nodes:
            if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef)):
                continue  # nested defs are separate (unresolved) scopes
            if isinstance(child, ast.With):
                new_held = list(held)
                for item in child.items:
                    # the context expressions themselves may contain calls
                    walk_nodes(fn, [item.context_expr], held, cls)
                    lock_id = facts.resolve_lock_expr(item.context_expr, cls)
                    if lock_id is None:
                        continue
                    for h in new_held:
                        # h == lock_id is a SELF-edge: re-acquisition
                        # while held (self-deadlock on a plain Lock)
                        fn.edges.append((h, lock_id, child.lineno))
                    fn.acquires.append((lock_id, child.lineno))
                    new_held.append(lock_id)
                walk_nodes(fn, child.body, tuple(new_held), cls)
                continue
            if isinstance(child, ast.Call):
                keys = _call_keys(facts, child, cls)
                if keys:
                    fn.calls.append(_Call(child.lineno, held, keys))
            walk_nodes(fn, list(ast.iter_child_nodes(child)), held, cls)

    for node in ast.walk(ctx.tree):
        if not isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            continue
        cls = facts._enclosing_class(node)
        qual = (
            f"{facts.relpath}::{cls}.{node.name}"
            if cls
            else f"{facts.relpath}::{node.name}"
        )
        fn = _FuncInfo(qual, facts.relpath, cls, node.name)
        held: Tuple[str, ...] = ()
        if node.name.endswith("_locked"):
            # caller-holds convention: analyze the body as if the owning
            # scope's locks are already held
            assumed: List[str] = []
            if cls is not None:
                assumed.extend(facts.class_lock_attrs.get(cls, {}).values())
            else:
                assumed.extend(facts.module_lock_names.values())
            held = tuple(assumed)
        walk_nodes(fn, node.body, held, cls)
        facts.functions[qual] = fn


# names that collide with builtin-container/threading methods: a call
# like `_armed.pop(k)` or `_threads.remove(t)` must NOT unique-resolve
# to some class that happens to define the same method name — the
# receiver is far more likely a dict/list/set/Lock than the one class
# the name matched.  Derived from the builtin types this tree actually
# passes around, plus the threading primitives.
_UNIQUE_DENYLIST: Set[str] = set()
for _t in (dict, list, set, frozenset, tuple, str, bytes, bytearray):
    _UNIQUE_DENYLIST.update(n for n in dir(_t) if not n.startswith("__"))
_UNIQUE_DENYLIST.update(
    ("acquire", "release", "locked", "join", "start", "close", "put",
     "get", "get_nowait", "put_nowait", "set", "wait", "notify",
     "notify_all", "cancel", "result", "submit", "shutdown")
)


def _call_keys(
    facts: _ModuleFacts, node: ast.Call, cls: Optional[str]
) -> Tuple[Tuple, ...]:
    f = node.func
    if isinstance(f, ast.Name):
        imported = facts.func_imports.get(f.id)
        if imported is not None:
            return (("func", imported[0], imported[1]),)
        return (("func", facts.relpath, f.id),)
    if isinstance(f, ast.Attribute):
        base = f.value
        if isinstance(base, ast.Name):
            if base.id == "self" and cls is not None:
                return (("method", facts.relpath, cls, f.attr),)
            target = facts.module_imports.get(base.id)
            if target is not None:
                return (("func", target, f.attr),)
        if f.attr in _UNIQUE_DENYLIST:
            return ()
        return (("unique", f.attr),)
    return ()


# ---------------------------------------------------------------------------
# the program graph
# ---------------------------------------------------------------------------


class LockGraph:
    def __init__(self):
        self.locks: Dict[str, LockInfo] = {}
        # a -> b -> (file, line, via) witness of the first edge seen
        self.edges: Dict[str, Dict[str, Tuple[str, int, str]]] = {}

    def add_edge(
        self, a: str, b: str, relpath: str, line: int, via: str
    ) -> None:
        self.edges.setdefault(a, {}).setdefault(b, (relpath, line, via))

    def cycles(self) -> List[List[str]]:
        """Elementary cycles, deduped by node set (one report per knot)."""
        seen_sets: Set[frozenset] = set()
        out: List[List[str]] = []
        # DFS from each node with an explicit stack; bounded by the small
        # size of the lock population
        for start in sorted(self.edges):
            stack = [(start, [start])]
            visited_paths = 0
            while stack:
                nodeid, path = stack.pop()
                visited_paths += 1
                if visited_paths > 20000:
                    break  # defensive bound; the real graph is tiny
                for nxt in sorted(self.edges.get(nodeid, ())):
                    if nxt == start and len(path) > 1:
                        key = frozenset(path)
                        if key not in seen_sets:
                            seen_sets.add(key)
                            out.append(path[:])
                    elif nxt not in path and nxt > start:
                        # only walk nodes after `start` so each cycle is
                        # found from its smallest node exactly once
                        stack.append((nxt, path + [nxt]))
        return out

    def self_deadlocks(self) -> List[Tuple[str, Tuple[str, int, str]]]:
        out = []
        for a, targets in self.edges.items():
            if a in targets:
                info = self.locks.get(a)
                if info is not None and info.kind == "lock":
                    out.append((a, targets[a]))
        return out


def build_lock_graph(program: Program) -> LockGraph:
    known_paths = set(program.by_path)
    facts_by_path: Dict[str, _ModuleFacts] = {}
    for ctx in program.contexts:
        facts = _ModuleFacts(ctx, known_paths)
        _analyze_functions(facts)
        facts_by_path[ctx.relpath] = facts

    graph = LockGraph()
    all_funcs: Dict[str, _FuncInfo] = {}
    by_name: Dict[Tuple[str, str], _FuncInfo] = {}  # (relpath, name) module fns
    by_method: Dict[Tuple[str, str, str], _FuncInfo] = {}
    method_name_count: Dict[str, List[_FuncInfo]] = {}
    for facts in facts_by_path.values():
        graph.locks.update(facts.locks)
        for fn in facts.functions.values():
            all_funcs[fn.qualname] = fn
            if fn.cls is None:
                by_name[(fn.relpath, fn.name)] = fn
            else:
                by_method[(fn.relpath, fn.cls, fn.name)] = fn
                method_name_count.setdefault(fn.name, []).append(fn)

    def resolve(call: _Call) -> Optional[_FuncInfo]:
        for key in call.keys:
            if key[0] == "func":
                fn = by_name.get((key[1], key[2]))
                if fn is not None:
                    return fn
            elif key[0] == "method":
                fn = by_method.get((key[1], key[2], key[3]))
                if fn is not None:
                    return fn
            elif key[0] == "unique":
                cands = method_name_count.get(key[1], ())
                if len(cands) == 1:
                    return cands[0]
        return None

    # seed may-acquire with direct acquisitions, then propagate through
    # resolved calls to a fixpoint
    for fn in all_funcs.values():
        for lock_id, line in fn.acquires:
            fn.may_acquire.setdefault(lock_id, (fn.qualname, line))
    changed = True
    rounds = 0
    while changed and rounds < 50:
        changed = False
        rounds += 1
        for fn in all_funcs.values():
            for call in fn.calls:
                callee = resolve(call)
                if callee is None:
                    continue
                for lock_id, witness in callee.may_acquire.items():
                    if lock_id not in fn.may_acquire:
                        fn.may_acquire[lock_id] = witness
                        changed = True

    # edges: lexical nesting + call-mediated
    for fn in all_funcs.values():
        for a, b, line in fn.edges:
            graph.add_edge(a, b, fn.relpath, line, f"nested with in {fn.qualname}")
        for call in fn.calls:
            if not call.held:
                continue
            callee = resolve(call)
            if callee is None:
                continue
            for lock_id, (wq, wl) in callee.may_acquire.items():
                for h in call.held:
                    # h == lock_id included: a call that re-acquires a
                    # held non-reentrant lock is a self-deadlock
                    graph.add_edge(
                        h, lock_id, fn.relpath, call.line,
                        f"call to {callee.qualname} (acquires at "
                        f"{wq.split('::')[0]}:{wl})",
                    )
    return graph


# ---------------------------------------------------------------------------
# the rule
# ---------------------------------------------------------------------------


def _short(lock_id: str) -> str:
    relpath, name = lock_id.split("::", 1)
    return f"{relpath.replace('celestia_tpu_torch/', '')}::{name}"


@register
class LockOrderRule(ProgramRule):
    id = "lock-order"
    summary = "the cross-module lock-acquisition graph must stay acyclic"
    doc = (
        "Builds one directed graph over every threading.Lock/RLock in "
        "the package (with-nesting, guarded-by annotations, the *_locked "
        "caller-holds convention, intra-package call resolution) and "
        "fails on any cycle — a potential AB/BA deadlock — printing the "
        "offending acquisition chain.  A non-reentrant Lock re-acquired "
        "while held is reported as a self-deadlock.  Full-tree runs also "
        "verify specs/lock_hierarchy_torch.md matches the derived graph "
        f"(regenerate: {REGEN_CMD})."
    )

    def check_program(self, program: Program) -> Iterator[Finding]:
        graph = build_lock_graph(program)
        for lock_id, (relpath, line, via) in graph.self_deadlocks():
            yield Finding(
                self.id, relpath, line, 0,
                f"non-reentrant lock {_short(lock_id)} may be re-acquired "
                f"while already held ({via}) — an immediate self-deadlock; "
                "use the *_locked caller-holds convention or an RLock",
            )
        for cycle in graph.cycles():
            chain = []
            hops = cycle + [cycle[0]]
            first_site = None
            for a, b in zip(hops, hops[1:]):
                relpath, line, via = graph.edges[a][b]
                if first_site is None:
                    first_site = (relpath, line)
                chain.append(
                    f"{_short(a)} -> {_short(b)} ({relpath}:{line}, {via})"
                )
            relpath, line = first_site if first_site else ("", 0)
            yield Finding(
                self.id, relpath, line, 0,
                "lock-order cycle (potential deadlock): " + "; ".join(chain),
            )
        if program.full_tree:
            want = render_hierarchy(graph)
            path = REPO_ROOT / HIERARCHY_PATH
            have = path.read_text() if path.is_file() else ""
            if have != want:
                yield Finding(
                    self.id, HIERARCHY_PATH, 1, 0,
                    "specs/lock_hierarchy_torch.md is out of date with the "
                    f"derived lock graph — regenerate with `{REGEN_CMD}`",
                )


# ---------------------------------------------------------------------------
# hierarchy document + lockwatch bridge
# ---------------------------------------------------------------------------


def _rank_locks(graph: LockGraph) -> Dict[str, int]:
    """Longest-path rank of each lock in the (acyclic) graph: rank 0
    locks are acquired first, higher ranks only while lower ones may be
    held.  Cyclic graphs fall back to rank 0 everywhere (the cycle is
    already a finding)."""
    ranks = {lock_id: 0 for lock_id in graph.locks}
    for _ in range(len(graph.locks) + 1):
        changed = False
        for a, targets in graph.edges.items():
            for b in targets:
                if a == b:
                    continue
                if a in ranks and b in ranks and ranks[b] < ranks[a] + 1:
                    ranks[b] = ranks[a] + 1
                    changed = True
        if not changed:
            return ranks
    return {lock_id: 0 for lock_id in graph.locks}  # cycle: no stable rank


def render_hierarchy(graph: LockGraph) -> str:
    """The generated specs/lock_hierarchy_torch.md body: every lock with its
    declaration site and rank, every edge with its witness.  Fully
    deterministic so drift checking is an exact string compare."""
    ranks = _rank_locks(graph)
    lines = [
        "# Lock hierarchy (generated)",
        "",
        "<!-- GENERATED FILE — do not edit by hand. -->",
        f"<!-- Regenerate with: {REGEN_CMD} -->",
        "",
        "Derived by celint R6 (`lock-order`) from the package's lock-",
        "acquisition graph: `with` nesting, `guarded-by` annotations, the",
        "`*_locked` caller-holds convention, and intra-package call",
        "resolution.  A lock may only be acquired while holding locks of",
        "a strictly LOWER rank; celint fails the build on any cycle, and",
        "utils/lockwatch.py cross-checks the observed runtime order",
        "against this graph under `CELESTIA_TPU_TORCH_LOCKWATCH=1`.",
        "",
        "## Locks by rank",
        "",
    ]
    by_rank: Dict[int, List[str]] = {}
    for lock_id in sorted(graph.locks):
        by_rank.setdefault(ranks.get(lock_id, 0), []).append(lock_id)
    for rank in sorted(by_rank):
        lines.append(f"### Rank {rank}")
        lines.append("")
        for lock_id in by_rank[rank]:
            info = graph.locks[lock_id]
            lines.append(
                f"- `{_short(lock_id)}` ({info.kind}, "
                f"{info.relpath}:{info.line})"
            )
        lines.append("")
    lines.append("## Acquisition edges")
    lines.append("")
    if not any(graph.edges.values()):
        lines.append("(none observed)")
    for a in sorted(graph.edges):
        for b in sorted(graph.edges[a]):
            relpath, line, via = graph.edges[a][b]
            lines.append(
                f"- `{_short(a)}` → `{_short(b)}` — {relpath}:{line} ({via})"
            )
    lines.append("")
    return "\n".join(lines)


def _full_tree_program() -> Program:
    from celestia_tpu_torch.lint.engine import iter_py_files

    contexts = []
    for path in iter_py_files([REPO_ROOT / "celestia_tpu_torch"]):
        rel = str(path.resolve().relative_to(REPO_ROOT)).replace("\\", "/")
        try:
            contexts.append(ModuleContext(rel, path.read_text()))
        except SyntaxError:
            continue
    return Program(contexts, full_tree=True)


def write_lock_hierarchy() -> Path:
    """Regenerate specs/lock_hierarchy_torch.md from the current tree."""
    graph = build_lock_graph(_full_tree_program())
    path = REPO_ROOT / HIERARCHY_PATH
    path.write_text(render_hierarchy(graph))
    return path


def lock_decl_sites(graph: Optional[LockGraph] = None) -> Dict[Tuple[str, int], str]:
    """(relpath, line) of every lock declaration -> lock id.  The bridge
    utils/lockwatch.py's runtime observations are joined on: a watched
    lock knows only WHERE it was constructed."""
    if graph is None:
        graph = build_lock_graph(_full_tree_program())
    return {
        (info.relpath, info.line): lock_id
        for lock_id, info in graph.locks.items()
    }


def runtime_crosscheck(
    observed_pairs: Dict[Tuple[Tuple[str, int], Tuple[str, int]], str],
    graph: Optional[LockGraph] = None,
) -> List[str]:
    """Cross-check lockwatch's observed acquisition pairs against the
    static graph.  ``observed_pairs`` maps ((file, line), (file, line))
    construction-site pairs (A held while B acquired) to a stack
    summary.  Returns one message per contradiction: an observed order
    whose REVERSE is reachable in the static graph — execution proving
    the static cycle risk is real — or an observed A->B together with an
    observed B->A (a live inversion even if the static pass missed it)."""
    if graph is None:
        graph = build_lock_graph(_full_tree_program())
    decls = lock_decl_sites(graph)

    def reachable(a: str, b: str) -> bool:
        seen: Set[str] = set()
        stack = [a]
        while stack:
            cur = stack.pop()
            if cur == b:
                return True
            if cur in seen:
                continue
            seen.add(cur)
            stack.extend(graph.edges.get(cur, ()))
        return False

    problems: List[str] = []
    mapped: Dict[Tuple[str, str], str] = {}
    for (site_a, site_b), stack_summary in sorted(observed_pairs.items()):
        a = decls.get(site_a)
        b = decls.get(site_b)
        if a is None or b is None or a == b:
            continue
        mapped[(a, b)] = stack_summary
    for (a, b), stack_summary in sorted(mapped.items()):
        if (b, a) in mapped:
            if a < b:  # report each inversion once
                problems.append(
                    f"runtime inversion: {_short(a)} -> {_short(b)} AND "
                    f"{_short(b)} -> {_short(a)} both observed\n"
                    f"  {stack_summary}\n  {mapped[(b, a)]}"
                )
        elif reachable(b, a):
            problems.append(
                f"observed {_short(a)} -> {_short(b)} contradicts the "
                f"static order ({_short(b)} precedes {_short(a)} in the "
                f"lock graph)\n  {stack_summary}"
            )
    return problems
