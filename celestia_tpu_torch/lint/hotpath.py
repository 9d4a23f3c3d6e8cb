"""R7 ``host-sync`` and R8 ``layering``: hot-path and architecture rules.

The port's counterpart of ``celestia_tpu/lint/hotpath.py``.  R8 is the JAX
rule over the port's packages (plus its own ``kernels`` and ``tools``).
R7 is re-homed for torch: the JAX rule knows device values only as jax
values, so it cannot see a ``.item()`` or a ``.cpu()`` on a CUDA tensor.

**R7** keeps implicit device→host synchronisation out of the card's hot
path: in ``da/``, ``ops/`` and ``state/`` a device value may cross to the
host only through a devprof ``dispatch()`` bracket (whose ``done()`` drains
the device on the profiled timeline), a devprof ``fetch()`` leg (the
plane's designed transfer boundary, charged to the transfer ledger), or a
sanctioned function.

*Device values* (flow-insensitive, per function, as JAX's ``_ScopeFacts``):
a ``torch.*`` call given a ``device=`` other than the CPU; ``.cuda()`` and
``.to(...)`` onto a device (a dtype argument alone is not a move); a call
of a kernel wrapper, i.e. an ``ops/*`` function that launches a kernel
through ``celestia_tpu_torch.kernels`` or returns such a function's
result; and what derives from a device value by copy, indexing, a tensor
method or a ``torch.*`` function of it.

*Syncs:* ``.item()``, ``.tolist()``, ``.cpu()``, ``.numpy()`` of a device
value, ``np.asarray``/``np.array``/``float``/``int``/``bool`` of one, and
every ``torch.cuda.synchronize()`` or ``.synchronize()`` of an event or a
stream (these wait for the whole device, whatever the value).

Inference stays conservative: attribute chains (``self._tensor``) and
unresolved calls are not device values -- missing a sync is a known cost,
flagging a host-only path would teach people to sprinkle allows.

**R8** enforces the package DAG so the sharding refactor cannot tangle
imports::

    appconsts → kernels → utils → ops → da → parallel → state → node →
    client → cli → lint → tools

An import (module-level OR lazy, inside a function) from a package at
the same or a higher layer is a back-edge finding.  ``lint`` is imported
by nothing in the tree but ``tools``.
"""

from __future__ import annotations

import ast
from typing import Dict, Iterator, List, Optional, Set, Tuple

from celestia_tpu_torch.lint.engine import (
    REPO_ROOT,
    Finding,
    ModuleContext,
    Rule,
    register,
)

# ---------------------------------------------------------------------------
# R7: host-sync
# ---------------------------------------------------------------------------

_PKG = "celestia_tpu_torch"

_HOT_PREFIXES = (
    f"{_PKG}/da/",
    f"{_PKG}/ops/",
    f"{_PKG}/state/",
)

# functions whose host syncs are the design, not an accident: diagnostic
# breakdowns that exist to MEASURE the transfer boundary.  Entries are
# (relpath, function name); keep this list short and argued — everything
# else carries a per-line allow with a reason.
HOT_SYNC_SANCTIONED: Tuple[Tuple[str, str], ...] = (
    # the three-phase timing split (upload / compute / fetch) kept for
    # attribution; it synchronises between phases by design and is on no
    # serving path
    (f"{_PKG}/da/dah.py", "extend_and_header_breakdown"),
)

# tensor methods that hand the host a value (or wait for the device)
_SYNC_METHODS = ("item", "tolist", "cpu", "numpy")

# tensor methods whose result is a host number or object, not a tensor
_HOST_METHODS = {
    "size", "dim", "numel", "element_size", "data_ptr", "stride",
    "is_contiguous", "storage_offset", "get_device", "nelement",
    "untyped_storage", "__len__",
}

# torch.<dtype> spellings: `.to(torch.uint8)` converts, it does not move
_DTYPE_NAMES = {
    "uint8", "int8", "int16", "int32", "int64", "uint16", "uint32",
    "uint64", "float16", "bfloat16", "float32", "float64", "bool",
    "half", "float", "double", "int", "long", "short", "complex64",
}


class _ScopeFacts:
    """Flow-insensitive per-function dataflow: which names hold device
    values, which hold devprof brackets, which were drained by a
    bracket's done()."""

    def __init__(self):
        self.tainted: Set[str] = set()
        self.brackets: Set[str] = set()
        self.drained: Set[str] = set()


class _Aliases:
    def __init__(self):
        self.numpy: Set[str] = set()
        self.torch: Set[str] = set()
        self.devprof: Set[str] = set()
        self.dispatch_fns: Set[str] = set()  # from ...devprof import dispatch
        self.kernels: Set[str] = set()
        # local alias -> ops module relpath (from celestia_tpu_torch.ops import rs)
        self.ops_modules: Dict[str, str] = {}
        # bare names that are kernel wrappers (imported, or this module's own)
        self.launch_fns: Set[str] = set()
        # ...of which these return their result through a bracket's done()
        self.bracketed_fns: Set[str] = set()


@register
class HostSyncRule(Rule):
    id = "host-sync"
    summary = "no implicit device->host syncs in the da/ops/state hot path"
    doc = (
        "In celestia_tpu_torch/{da,ops,state}/ flags .item(), .tolist(), "
        ".cpu(), .numpy(), np.asarray/np.array/float/int/bool of a value "
        "inferred device-resident (a torch.* call with a device, .cuda(), "
        ".to(<device>), a kernel wrapper's result, or what derives from "
        "one), and every torch.cuda.synchronize() or event/stream "
        ".synchronize(), unless the value went through a devprof "
        "dispatch() bracket's done() or a devprof fetch() leg -- the "
        "sanctioned crossings -- or the enclosing function is on the "
        "HOT_SYNC_SANCTIONED list (measurement paths).  Host round-trips "
        "serialize the device pipeline (2108.02692); every survivor must "
        "be deliberate."
    )

    def check(self, ctx: ModuleContext) -> Iterator[Finding]:
        if not ctx.relpath.startswith(_HOT_PREFIXES):
            return
        aliases = _collect_aliases(ctx.tree)
        # this module's own wrappers (a fixture that exists only in memory
        # derives them from its own tree)
        aliases.launch_fns |= launch_functions().get(ctx.relpath, set())
        aliases.launch_fns |= _module_launch_fns(ctx.tree, aliases)
        aliases.bracketed_fns |= _bracketed_fns(ctx.tree, aliases)
        sanctioned = {
            fn for (rel, fn) in HOT_SYNC_SANCTIONED if rel == ctx.relpath
        }
        for scope_node, scope_name in _scopes(ctx.tree):
            if scope_name in sanctioned:
                continue
            facts = _scope_facts(scope_node, aliases)
            yield from self._check_scope(ctx, scope_node, facts, aliases)

    def _check_scope(self, ctx, scope_node, facts, aliases) -> Iterator[Finding]:
        for node in _walk_scope(scope_node):
            if not isinstance(node, ast.Call):
                continue
            f = node.func
            # torch.cuda.synchronize() / event.synchronize() / stream.synchronize()
            if isinstance(f, ast.Attribute) and f.attr == "synchronize":
                yield Finding(
                    self.id, ctx.relpath, node.lineno, node.col_offset,
                    f"{ast.unparse(f)}() waits for the device in the hot "
                    "path -- route the dispatch through devprof.dispatch()/"
                    "done(), which drains it on the profiled timeline",
                )
                continue
            # x.item() / x.tolist() / x.cpu() / x.numpy() of a device value
            if (
                isinstance(f, ast.Attribute)
                and f.attr in _SYNC_METHODS
                and not node.args
                and _is_live_device(facts, f.value, aliases)
            ):
                yield Finding(
                    self.id, ctx.relpath, node.lineno, node.col_offset,
                    f".{f.attr}() of a device value syncs it to the host "
                    "outside a devprof bracket -- fetch it with "
                    "devprof.fetch(<leg>, t) after d.done(...), or keep "
                    "the value on the device",
                )
                continue
            # np.asarray/np.array/float/int/bool of a device value
            sync_kind = _sync_call_kind(f, aliases)
            if sync_kind is None or len(node.args) < 1:
                continue
            arg = node.args[0]
            if _is_live_device(facts, arg, aliases):
                yield Finding(
                    self.id, ctx.relpath, node.lineno, node.col_offset,
                    f"{sync_kind}({ast.unparse(arg)}) implicitly syncs a "
                    "device value to the host outside a devprof dispatch() "
                    "bracket -- wrap the dispatch (out = d.done(fn(x))) "
                    "and fetch it, or keep the value on the device",
                )


def _ops_relpath(dotted: str) -> Optional[str]:
    """``celestia_tpu_torch.ops.rs`` -> ``celestia_tpu_torch/ops/rs.py``."""
    parts = dotted.split(".")
    if len(parts) == 3 and parts[0] == _PKG and parts[1] == "ops":
        return f"{_PKG}/ops/{parts[2]}.py"
    return None


def _collect_aliases(tree: ast.AST) -> _Aliases:
    """Import aliases of one module; imported kernel wrappers resolve
    against :func:`launch_functions` (the table so far while it is being
    built)."""
    out = _Aliases()
    launch = launch_functions()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                local = a.asname or a.name.split(".")[0]
                if a.name == "numpy":
                    out.numpy.add(local)
                elif a.name == "torch":
                    out.torch.add(local)
                elif a.name == f"{_PKG}.kernels" and a.asname:
                    out.kernels.add(a.asname)
                elif _ops_relpath(a.name) and a.asname:
                    out.ops_modules[a.asname] = _ops_relpath(a.name)
        elif isinstance(node, ast.ImportFrom) and node.module:
            mod = node.module
            for a in node.names:
                local = a.asname or a.name
                if mod == _PKG and a.name == "kernels":
                    out.kernels.add(local)
                elif mod == f"{_PKG}.ops" and _ops_relpath(f"{mod}.{a.name}"):
                    out.ops_modules[local] = _ops_relpath(f"{mod}.{a.name}")
                elif _ops_relpath(mod) and a.name in launch.get(_ops_relpath(mod), ()):
                    out.launch_fns.add(local)
                    if a.name in _BRACKETED.get(_ops_relpath(mod), ()):
                        out.bracketed_fns.add(local)
                elif mod.startswith(_PKG) and a.name == "devprof":
                    out.devprof.add(local)
                elif mod.startswith(_PKG) and a.name == "dispatch":
                    out.dispatch_fns.add(local)
    return out


def _scopes(tree: ast.AST):
    """(scope node, name) for the module body and every function."""
    yield tree, "<module>"
    for node in ast.walk(tree):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            yield node, node.name


def _walk_scope(scope_node: ast.AST):
    """Walk a scope without descending into nested function defs (each
    function is its own dataflow scope)."""
    stack = list(ast.iter_child_nodes(scope_node))
    while stack:
        node = stack.pop()
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            continue
        yield node
        stack.extend(ast.iter_child_nodes(node))


def _scope_facts(scope_node: ast.AST, aliases: _Aliases) -> _ScopeFacts:
    facts = _ScopeFacts()
    nodes = list(_walk_scope(scope_node))
    # passes until nothing changes, so the order of definition within
    # the scope doesn't matter (flow-insensitive: a name EVER drained is
    # treated as drained)
    while True:
        before = (len(facts.tainted), len(facts.brackets), len(facts.drained))
        for node in nodes:
            if isinstance(node, ast.Assign):
                _note_assign(facts, node.targets, node.value, aliases)
            elif isinstance(node, ast.AnnAssign) and node.value is not None:
                _note_assign(facts, [node.target], node.value, aliases)
            elif isinstance(node, ast.Expr) and isinstance(node.value, ast.Call):
                _note_done_statement(facts, node.value)
                _note_append(facts, node.value, aliases)
        if (len(facts.tainted), len(facts.brackets), len(facts.drained)) == before:
            return facts


def _note_assign(facts, targets, value, aliases) -> None:
    names: List[str] = []
    for t in targets:
        if isinstance(t, ast.Name):
            names.append(t.id)
        elif isinstance(t, (ast.Tuple, ast.List)):
            names.extend(e.id for e in t.elts if isinstance(e, ast.Name))
    if not names:
        return
    if _is_done_call(facts, value):
        # out = d.done(fn(x)): drained by the sanctioned bracket
        facts.drained.update(names)
        _mark_done_arg(facts, value)
        return
    if isinstance(value, ast.Call) and _is_bracketed_call(value.func, aliases):
        facts.drained.update(names)
        return
    if _is_device_expr(facts, value, aliases):
        facts.tainted.update(names)
    if _is_bracket_ctor(value, aliases):
        facts.brackets.update(names)
    if isinstance(value, ast.Name) and value.id in facts.drained:
        facts.drained.update(names)


def _note_append(facts, call: ast.Call, aliases) -> None:
    """``parts.append(t)`` of a device value: the list holds device values."""
    f = call.func
    if (
        isinstance(f, ast.Attribute)
        and f.attr in ("append", "extend", "insert")
        and isinstance(f.value, ast.Name)
        and any(_is_device_expr(facts, a, aliases) for a in call.args)
    ):
        facts.tainted.add(f.value.id)


def _note_done_statement(facts, call: ast.Call) -> None:
    if _is_done_call(facts, call):
        _mark_done_arg(facts, call)


def _mark_done_arg(facts, call: ast.Call) -> None:
    for arg in call.args:
        if isinstance(arg, ast.Name):
            facts.drained.add(arg.id)


def _is_done_call(facts, node: ast.AST) -> bool:
    return (
        isinstance(node, ast.Call)
        and isinstance(node.func, ast.Attribute)
        and node.func.attr == "done"
        and isinstance(node.func.value, ast.Name)
        and node.func.value.id in facts.brackets
    )


def _is_bracket_ctor(node: ast.AST, aliases: _Aliases) -> bool:
    if not isinstance(node, ast.Call):
        return False
    f = node.func
    if isinstance(f, ast.Attribute) and isinstance(f.value, ast.Name):
        return f.value.id in aliases.devprof and f.attr == "dispatch"
    if isinstance(f, ast.Name):
        return f.id in aliases.dispatch_fns
    return False


def _is_cpu_literal(node: ast.AST, aliases: _Aliases) -> bool:
    """``"cpu"`` or ``torch.device("cpu")``."""
    if isinstance(node, ast.Constant):
        return isinstance(node.value, str) and node.value.split(":")[0] == "cpu"
    if (
        isinstance(node, ast.Call)
        and isinstance(node.func, ast.Attribute)
        and node.func.attr == "device"
        and node.args
    ):
        return _is_cpu_literal(node.args[0], aliases)
    return False


def _is_dtype(node: ast.AST, aliases: _Aliases) -> bool:
    if (
        isinstance(node, ast.Attribute)
        and isinstance(node.value, ast.Name)
        and node.value.id in aliases.torch
    ):
        return node.attr in _DTYPE_NAMES
    if isinstance(node, ast.Name):
        return "dtype" in node.id.lower()
    if isinstance(node, ast.Attribute):
        return node.attr == "dtype"
    return False


def _device_kw(call: ast.Call) -> Optional[ast.AST]:
    for kw in call.keywords:
        if kw.arg == "device":
            return kw.value
    return None


def _is_torch_call(f: ast.AST, aliases: _Aliases) -> bool:
    """torch.<fn>(...) (not torch.cuda.* / torch.device / torch.Tensor)."""
    return (
        isinstance(f, ast.Attribute)
        and isinstance(f.value, ast.Name)
        and f.value.id in aliases.torch
        and f.attr not in ("device", "Generator")
    )


def _is_launch_call(f: ast.AST, aliases: _Aliases) -> bool:
    if isinstance(f, ast.Name):
        return f.id in aliases.launch_fns
    if isinstance(f, ast.Attribute) and isinstance(f.value, ast.Name):
        rel = aliases.ops_modules.get(f.value.id)
        return rel is not None and f.attr in launch_functions().get(rel, ())
    return False


def _is_bracketed_call(f: ast.AST, aliases: _Aliases) -> bool:
    """A wrapper that hands back ``d.done(...)``: its result was drained
    by the sanctioned bracket (``nmt.eds_nmt_roots_device``)."""
    if isinstance(f, ast.Name):
        return f.id in aliases.bracketed_fns
    if isinstance(f, ast.Attribute) and isinstance(f.value, ast.Name):
        rel = aliases.ops_modules.get(f.value.id)
        launch_functions()
        return rel is not None and f.attr in _BRACKETED.get(rel, ())
    return False


def _is_device_expr(facts, node: ast.AST, aliases: _Aliases) -> bool:
    """True when ``node`` evaluates to a value the rule infers lives on the
    device (names not yet drained included)."""
    if isinstance(node, ast.Name):
        return node.id in facts.tainted
    if isinstance(node, ast.Subscript):
        return _is_device_expr(facts, node.value, aliases)
    if isinstance(node, (ast.List, ast.Tuple)):
        return any(_is_device_expr(facts, e, aliases) for e in node.elts)
    if not isinstance(node, ast.Call):
        return False
    f = node.func
    if _is_launch_call(f, aliases):
        return not _is_bracketed_call(f, aliases)
    if _is_torch_call(f, aliases):
        dev = _device_kw(node)
        if dev is not None:
            return not _is_cpu_literal(dev, aliases)
        # torch.cat([a, b]), torch.stack(...), torch.where(m, a, b)
        return any(_is_device_expr(facts, a, aliases) for a in node.args)
    if isinstance(f, ast.Attribute):
        if f.attr == "cuda":
            return True
        if f.attr == "to":
            dev = _device_kw(node)
            if dev is not None:
                return not _is_cpu_literal(dev, aliases)
            if node.args:
                a0 = node.args[0]
                if _is_cpu_literal(a0, aliases):
                    return False
                if not _is_dtype(a0, aliases):
                    return True
            return _is_device_expr(facts, f.value, aliases)
        if f.attr in _SYNC_METHODS or f.attr in _HOST_METHODS:
            return False
        # a tensor method of a device value stays on the device
        return _is_device_expr(facts, f.value, aliases)
    return False


def _is_live_device(facts, node: ast.AST, aliases: _Aliases) -> bool:
    """A device value that no done() drained."""
    if isinstance(node, ast.Name) and node.id in facts.drained:
        return False
    return _is_device_expr(facts, node, aliases)


def _sync_call_kind(f: ast.AST, aliases: _Aliases) -> Optional[str]:
    """'np.asarray'-style label when ``f`` is a banned implicit-sync
    callable (numpy converters, scalar builtins), else None."""
    if isinstance(f, ast.Attribute) and isinstance(f.value, ast.Name):
        if f.value.id in aliases.numpy and f.attr in ("asarray", "array"):
            return f"{f.value.id}.{f.attr}"
        return None
    if isinstance(f, ast.Name) and f.id in ("float", "int", "bool"):
        return f.id
    return None


# -- the kernel wrappers ------------------------------------------------


def _launches_directly(fn: ast.AST, kernels_aliases: Set[str]) -> bool:
    for n in ast.walk(fn):
        if (
            isinstance(n, ast.Call)
            and isinstance(n.func, ast.Attribute)
            and n.func.attr in ("launch", "call")
            and isinstance(n.func.value, ast.Name)
            and n.func.value.id in kernels_aliases
        ):
            return True
    return False


def _returns_device(fn: ast.AST, aliases: _Aliases) -> bool:
    facts = _scope_facts(fn, aliases)
    for n in _walk_scope(fn):
        if isinstance(n, ast.Return) and n.value is not None:
            v = n.value
            if _is_done_call(facts, v) and v.args:
                v = v.args[0]  # return d.done(fn(x)): the device result
            if isinstance(v, ast.Name) and v.id in facts.drained:
                return True
            if _is_device_expr(facts, v, aliases):
                return True
    return False


def _refers_to_wrapper(fn: ast.AST, aliases: _Aliases) -> bool:
    """``fn`` calls a wrapper or hands one on (``_eds_roots(eds,
    eds_leaf_digests, grid_levels)``)."""
    for n in ast.walk(fn):
        if isinstance(n, ast.Name) and n.id in aliases.launch_fns:
            return True
        if isinstance(n, ast.Attribute) and _is_launch_call(n, aliases):
            return True
    return False


def _module_launch_fns(tree: ast.AST, aliases: _Aliases) -> Set[str]:
    """Top-level functions of one module that are kernel wrappers: they
    launch through ``kernels``, or reach a wrapper and give back a tensor
    (to a fixpoint, so ``extend_batched`` -> ``extend_batched_cuda``
    counts).  A return annotation without ``Tensor`` (``-> np.ndarray``,
    ``-> None``) rules a function out: its result is on the host; without
    an annotation a return of a device value is asked for."""
    fns = {
        n.name: n for n in getattr(tree, "body", ())
        if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))
    }

    def tensor_result(fn) -> Optional[bool]:
        if fn.returns is None:
            return None
        return "Tensor" in ast.unparse(fn.returns)

    found = {
        name for name, fn in fns.items()
        if tensor_result(fn) is not False
        and _launches_directly(fn, aliases.kernels)
    }
    saved = aliases.launch_fns
    try:
        while True:
            aliases.launch_fns = saved | found
            more = set()
            for name, fn in fns.items():
                if name in found or tensor_result(fn) is False:
                    continue
                if tensor_result(fn) and _refers_to_wrapper(fn, aliases):
                    more.add(name)
                elif _returns_device(fn, aliases):
                    more.add(name)
            if not more:
                return found
            found |= more
    finally:
        aliases.launch_fns = saved


def _bracketed_fns(tree: ast.AST, aliases: _Aliases) -> Set[str]:
    """The wrappers among ``tree``'s functions whose every return is a
    bracket's ``done()`` (or a name it drained)."""
    out = set()
    for fn in getattr(tree, "body", ()):
        if not isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef)):
            continue
        if fn.name not in aliases.launch_fns:
            continue
        facts = _scope_facts(fn, aliases)
        rets = [
            n.value for n in _walk_scope(fn)
            if isinstance(n, ast.Return) and n.value is not None
        ]
        if rets and all(
            _is_done_call(facts, v)
            or (isinstance(v, ast.Name) and v.id in facts.drained)
            for v in rets
        ):
            out.add(fn.name)
    return out


_LAUNCH_CACHE: Optional[Dict[str, Set[str]]] = None
_BRACKETED: Dict[str, Set[str]] = {}


def launch_functions() -> Dict[str, Set[str]]:
    """ops relpath -> the names of its kernel wrappers, derived once from
    the tree's ``celestia_tpu_torch/ops/*.py``."""
    global _LAUNCH_CACHE
    if _LAUNCH_CACHE is None:
        _LAUNCH_CACHE = {}
        trees = {}
        for path in sorted((REPO_ROOT / _PKG / "ops").glob("*.py")):
            rel = f"{_PKG}/ops/{path.name}"
            try:
                trees[rel] = ast.parse(path.read_text())
            except (OSError, SyntaxError):
                continue
            _LAUNCH_CACHE[rel] = set()
        # cross-module wrappers (ops/nmt returning an ops/gather result)
        # settle in a few rounds
        for _ in range(4):
            changed = False
            for rel, tree in trees.items():
                fns = _module_launch_fns(tree, _collect_aliases(tree))
                if fns - _LAUNCH_CACHE[rel]:
                    _LAUNCH_CACHE[rel] |= fns
                    changed = True
            if not changed:
                break
        for rel, tree in trees.items():
            aliases = _collect_aliases(tree)
            aliases.launch_fns |= _LAUNCH_CACHE[rel]
            _BRACKETED[rel] = _bracketed_fns(tree, aliases)
    return _LAUNCH_CACHE


# ---------------------------------------------------------------------------
# R8: layering
# ---------------------------------------------------------------------------

# the package DAG, base to top; an import may only reach STRICTLY lower
# layers (same-package imports are free)
#
# The port's own modules: ``kernels`` (the build, the ctypes binding and the
# launch counts) imports nothing of the package, and utils/devprof.py reads
# its counts, so it sits below utils.  ``ops/gather`` (imports kernels) and
# ``parallel/collectives`` (imports ops/rs) take their package's layer:
# their imports reach only lower layers.  ``tools`` (the smoke gates) drive
# everything, the lint included.
LAYERS: Dict[str, int] = {
    "appconsts": 0,
    "kernels": 1,
    "utils": 2,
    "ops": 3,
    "da": 4,
    "parallel": 5,
    "state": 6,
    "node": 7,
    "client": 8,
    "cli": 9,
    "lint": 10,
    "tools": 11,
    "__init__": 12,  # the package root may touch anything (env arming)
}

_DAG_TEXT = (
    "appconsts → kernels → utils → ops → da → parallel → state → node → "
    "client → cli → lint → tools"
)


def _layer_of(relpath: str) -> Optional[Tuple[str, int]]:
    parts = relpath.split("/")
    if len(parts) < 2 or parts[0] != "celestia_tpu_torch":
        return None
    seg = parts[1]
    if seg.endswith(".py"):
        seg = seg[:-3]
    rank = LAYERS.get(seg)
    return (seg, rank) if rank is not None else None


@register
class LayeringRule(Rule):
    id = "layering"
    summary = "package imports follow the DAG; no back-edges, no cycles"
    doc = (
        f"Enforces {_DAG_TEXT} (lint above all): an import — module-"
        "level or lazy — from a package at the same or a higher layer is "
        "a back-edge.  The upcoming sharding refactor reworks da/state/"
        "node heavily; the DAG is what keeps 'just import it from node' "
        "from quietly inverting the architecture.  Deliberate inversions "
        "carry allow(layering) with the architectural argument."
    )

    def check(self, ctx: ModuleContext) -> Iterator[Finding]:
        me = _layer_of(ctx.relpath)
        if me is None:
            return
        my_seg, my_rank = me
        for node in ast.walk(ctx.tree):
            targets: Set[Tuple[str, int]] = set()
            if isinstance(node, ast.Import):
                for a in node.names:
                    t = _import_target(a.name)
                    if t is not None:
                        targets.add(t)
            elif isinstance(node, ast.ImportFrom):
                # resolve relative imports against this file's package
                # so `from ..node import x` can't slip under the rule
                base = _absolute_module(ctx.relpath, node.level, node.module)
                if base is not None:
                    t = _import_target(base)
                    if t is not None:
                        targets.add(t)
                    # `from celestia_tpu_torch import node` names the package
                    # in the ALIAS, not in node.module — check each one
                    for a in node.names:
                        t = _import_target(f"{base}.{a.name}")
                        if t is not None:
                            targets.add(t)
            for seg, rank in sorted(targets):
                if seg == my_seg:
                    continue
                if rank >= my_rank:
                    yield Finding(
                        self.id, ctx.relpath, node.lineno, node.col_offset,
                        f"layering back-edge: {my_seg}/ may not import "
                        f"{seg}/ (DAG: {_DAG_TEXT})",
                    )


def _absolute_module(
    relpath: str, level: int, module: Optional[str]
) -> Optional[str]:
    """Dotted absolute module an ImportFrom refers to.  ``level`` 0 is
    already absolute; level k resolves against this file's package
    (``from ..node import x`` in state/modules/ → celestia_tpu_torch.node)."""
    if level == 0:
        return module
    pkg_parts = relpath.split("/")[:-1]  # drop the filename
    if level > 1:
        if level - 1 > len(pkg_parts):
            return None
        pkg_parts = pkg_parts[: len(pkg_parts) - (level - 1)]
    base = ".".join(pkg_parts)
    if not base:
        return None
    return f"{base}.{module}" if module else base


def _import_target(dotted: str) -> Optional[Tuple[str, int]]:
    parts = dotted.split(".")
    if parts[0] != "celestia_tpu_torch" or len(parts) < 2:
        return None
    rank = LAYERS.get(parts[1])
    return (parts[1], rank) if rank is not None else None
