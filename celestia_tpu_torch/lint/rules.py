"""The celint rule catalog (R1-R4).  See specs/static_analysis.md.

The port's copy of ``celestia_tpu/lint/rules.py``: its sanctioned modules
and consensus scopes are the port's.

Each rule encodes one invariant the concurrency work established by hand and cannot
afford to re-lose by review drift:

* ``guarded-by`` (R1) — annotated shared state mutates only under its
  declared lock (the unlocked commitment cache was the founding bug).
* ``no-handrolled-cache`` (R2) — the OrderedDict+eviction-loop pattern
  lives ONLY in utils/lru.py; everything else builds on LruCache, so
  bounding/locking/stats can't silently fork again.
* ``consensus-determinism`` (R3) — state/ and da/ never read wall
  clocks, OS entropy, or unordered-set iteration into consensus bytes;
  telemetry timestamps go through utils/telemetry clock(), the one
  auditable channel.
* ``hostpool-discipline`` (R4) — native ``nthreads`` always comes from
  utils/hostpool (or None, which resolves there); a literal thread count
  re-creates the oversubscription the process-wide pool exists to end.
* ``sanctioned-retry`` (R5) — bare ``except:``, ``except Exception:
  pass``-style swallows and hand-rolled ``time.sleep`` retry loops are
  forbidden outside utils/faults.py: failures are recorded via
  ``faults.note`` or propagate, and every sleep-retry goes through the
  one RetryPolicy (seeded backoff, deadline budgets) so recovery paths
  stay testable under the chaos harness.
"""

from __future__ import annotations

import ast
from typing import Dict, Iterator, List, Optional, Set, Tuple

from celestia_tpu_torch.lint.engine import (
    Finding,
    ModuleContext,
    Rule,
    normalize_expr,
    register,
)

# ---------------------------------------------------------------------------
# R1: guarded-by
# ---------------------------------------------------------------------------

# methods that mutate their receiver (dict/list/set/OrderedDict/deque)
_MUTATING_METHODS = {
    "pop", "popitem", "clear", "update", "setdefault",
    "append", "extend", "insert", "remove", "discard", "add",
    "move_to_end", "appendleft", "popleft",
}

# ("name", global_name) or ("self", attr_name)
_GuardKey = Tuple[str, str]


def _target_key(node: ast.AST) -> Optional[_GuardKey]:
    if isinstance(node, ast.Name):
        return ("name", node.id)
    if (
        isinstance(node, ast.Attribute)
        and isinstance(node.value, ast.Name)
        and node.value.id == "self"
    ):
        return ("self", node.attr)
    return None


@register
class GuardedByRule(Rule):
    id = "guarded-by"
    summary = "annotated shared state must be mutated under its declared lock"
    doc = (
        "A variable annotated `# celint: guarded-by(<lock>)` may only be "
        "mutated lexically inside `with <lock>:`.  Methods named *_locked "
        "are exempt (they document that the caller holds the lock)."
    )

    def check(self, ctx: ModuleContext) -> Iterator[Finding]:
        guards: Dict[_GuardKey, Tuple[str, int]] = {}
        for g in ctx.guards:
            found = False
            for node in ast.walk(ctx.tree):
                if not isinstance(node, (ast.Assign, ast.AnnAssign)):
                    continue
                if node.lineno != g.target_line:
                    continue
                targets = (
                    node.targets
                    if isinstance(node, ast.Assign)
                    else [node.target]
                )
                for t in targets:
                    key = _target_key(t)
                    if key is not None:
                        guards[key] = (g.lock, g.target_line)
                        found = True
            if not found:
                yield Finding(
                    self.id, ctx.relpath, g.line, 0,
                    "guarded-by annotation matches no assignment target "
                    "on its line",
                )
        if not guards:
            return
        for node in ast.walk(ctx.tree):
            for key, mutated in _mutations(node):
                entry = guards.get(key)
                if entry is None:
                    continue
                lock, decl_line = entry
                if mutated.lineno == decl_line:
                    continue  # the annotated initialization itself
                if lock in ctx.held_locks(mutated):
                    continue
                if any(
                    fn.endswith("_locked")
                    for fn in ctx.enclosing_functions(mutated)
                ):
                    continue
                name = key[1] if key[0] == "name" else f"self.{key[1]}"
                yield Finding(
                    self.id, ctx.relpath, mutated.lineno, mutated.col_offset,
                    f"{name} is guarded-by({lock}) but mutated outside "
                    f"`with {lock}:`",
                )


def _mutations(node: ast.AST) -> Iterator[Tuple[_GuardKey, ast.AST]]:
    """(guard key, offending node) for every mutation ``node`` performs."""
    if isinstance(node, ast.Assign):
        for t in node.targets:
            yield from _store_targets(t, node)
    elif isinstance(node, ast.AnnAssign) and node.value is not None:
        yield from _store_targets(node.target, node)
    elif isinstance(node, ast.AugAssign):
        yield from _store_targets(node.target, node)
    elif isinstance(node, ast.Delete):
        for t in node.targets:
            if isinstance(t, ast.Subscript):
                key = _target_key(t.value)
            else:
                key = _target_key(t)
            if key is not None:
                yield key, node
    elif isinstance(node, ast.Call):
        f = node.func
        if isinstance(f, ast.Attribute) and f.attr in _MUTATING_METHODS:
            key = _target_key(f.value)
            if key is not None:
                yield key, node


def _store_targets(
    t: ast.AST, node: ast.AST
) -> Iterator[Tuple[_GuardKey, ast.AST]]:
    if isinstance(t, ast.Subscript):
        key = _target_key(t.value)  # x[k] = v mutates x
    else:
        key = _target_key(t)  # x = v rebinds x
    if key is not None:
        yield key, node
    if isinstance(t, (ast.Tuple, ast.List)):
        for elt in t.elts:
            yield from _store_targets(elt, node)


# ---------------------------------------------------------------------------
# R2: no-handrolled-cache
# ---------------------------------------------------------------------------

# the one module allowed to implement the pattern
_SANCTIONED = "celestia_tpu_torch/utils/lru.py"


@register
class NoHandrolledCacheRule(Rule):
    id = "no-handrolled-cache"
    summary = "bounded caches are built on utils/lru.LruCache, nowhere else"
    doc = (
        "Flags the hand-rolled LRU pattern outside utils/lru.py: "
        "OrderedDict use, move_to_end/popitem calls, pop(next(iter(d))) "
        "FIFO eviction, and `while len(d) > cap` eviction loops.  Five "
        "independent copies of this pattern each drifted differently; "
        "LruCache is the audited implementation with locking and stats."
    )

    def check(self, ctx: ModuleContext) -> Iterator[Finding]:
        if ctx.relpath == _SANCTIONED:
            return
        for node in ast.walk(ctx.tree):
            if isinstance(node, ast.ImportFrom):
                if node.module == "collections" and any(
                    a.name == "OrderedDict" for a in node.names
                ):
                    yield Finding(
                        self.id, ctx.relpath, node.lineno, node.col_offset,
                        "OrderedDict import outside utils/lru.py — build "
                        "on celestia_tpu_torch.utils.lru.LruCache instead",
                    )
            elif isinstance(node, ast.Attribute) and node.attr == "OrderedDict":
                yield Finding(
                    self.id, ctx.relpath, node.lineno, node.col_offset,
                    "collections.OrderedDict outside utils/lru.py — build "
                    "on celestia_tpu_torch.utils.lru.LruCache instead",
                )
            elif isinstance(node, ast.Call):
                f = node.func
                if isinstance(f, ast.Attribute) and f.attr in (
                    "move_to_end",
                    "popitem",
                ):
                    yield Finding(
                        self.id, ctx.relpath, node.lineno, node.col_offset,
                        f".{f.attr}() is LRU bookkeeping — use "
                        "celestia_tpu_torch.utils.lru.LruCache",
                    )
                elif (
                    isinstance(f, ast.Attribute)
                    and f.attr == "pop"
                    and node.args
                    and _is_next_iter(node.args[0])
                ):
                    yield Finding(
                        self.id, ctx.relpath, node.lineno, node.col_offset,
                        ".pop(next(iter(...))) is a hand-rolled eviction — "
                        "use celestia_tpu_torch.utils.lru.LruCache",
                    )
            elif isinstance(node, ast.While) and _is_eviction_loop(node):
                yield Finding(
                    self.id, ctx.relpath, node.lineno, node.col_offset,
                    "`while len(...)` eviction loop — use "
                    "celestia_tpu_torch.utils.lru.LruCache",
                )


def _is_next_iter(node: ast.AST) -> bool:
    return (
        isinstance(node, ast.Call)
        and isinstance(node.func, ast.Name)
        and node.func.id == "next"
        and node.args
        and isinstance(node.args[0], ast.Call)
        and isinstance(node.args[0].func, ast.Name)
        and node.args[0].func.id == "iter"
    )


def _is_eviction_loop(node: ast.While) -> bool:
    test_has_len = any(
        isinstance(n, ast.Call)
        and isinstance(n.func, ast.Name)
        and n.func.id == "len"
        for n in ast.walk(node.test)
    )
    if not test_has_len:
        return False
    for n in ast.walk(node):
        if n is node:
            continue
        if isinstance(n, ast.Call) and isinstance(n.func, ast.Attribute):
            if n.func.attr in ("pop", "popitem", "popleft"):
                return True
        if isinstance(n, ast.Delete):
            return True
    return False


# ---------------------------------------------------------------------------
# R3: consensus-determinism
# ---------------------------------------------------------------------------

_CONSENSUS_PREFIXES = ("celestia_tpu_torch/state/", "celestia_tpu_torch/da/")
_TIME_FNS = {
    "time", "time_ns", "monotonic", "monotonic_ns",
    "perf_counter", "perf_counter_ns",
}

# The sanctioned wall-clock channels: the ONLY modules whose time.*
# reads are part of the design (utils/telemetry clock() feeds durations;
# utils/tracing builds spans on that same clock).  Consensus modules
# reach clocks exclusively THROUGH these; the channels themselves are
# scanned for the entropy bans (a tracer span id derived from random
# bits would be exactly the nondeterminism R3 exists to stop), while
# their wall-clock reads are, by definition, sanctioned.
SANCTIONED_CHANNELS = (
    "celestia_tpu_torch/utils/telemetry.py",
    "celestia_tpu_torch/utils/tracing.py",
    # the device half of the plane: dispatch brackets and the
    # occupancy window read the clock; its span/track identifiers must
    # stay as deterministic as the tracer's, so the entropy bans apply
    "celestia_tpu_torch/utils/devprof.py",
    # the continuous-telemetry ring stamps snapshot timestamps
    "celestia_tpu_torch/utils/timeseries.py",
    # the host sampling profiler stamps sample timestamps and measures
    # its own tick cost; its ids are thread ids + folded strings, so the
    # entropy bans apply (a randomized sampler would launder
    # nondeterminism through the one open door)
    "celestia_tpu_torch/utils/hostprof.py",
    # the flight recorder stamps incident timestamps; incident ids are
    # SEQUENCE numbers, never random — entropy bans enforced
    "celestia_tpu_torch/utils/flight.py",
)


@register
class ConsensusDeterminismRule(Rule):
    id = "consensus-determinism"
    summary = "no wall clocks, entropy, or set-iteration in state/ and da/"
    doc = (
        "In consensus modules (celestia_tpu_torch/state/, celestia_tpu_torch/da/) "
        "flags calls to time.time/time_ns/monotonic/perf_counter, any "
        "random.* / numpy .random.* / secrets.*, os.urandom, and "
        "iteration directly over a set (unordered -> nondeterministic "
        "bytes).  Telemetry durations go through the sanctioned-channel "
        "modules (utils/telemetry clock(), utils/tracing spans — "
        "SANCTIONED_CHANNELS); anything else needs an explicit allow "
        "with a reason.  The channel modules themselves are scanned for "
        "the ENTROPY bans only: their clock reads are the channel, but "
        "a random/urandom draw there (e.g. a random span id) would "
        "launder nondeterminism through the one door left open."
    )

    def check(self, ctx: ModuleContext) -> Iterator[Finding]:
        in_channel = ctx.relpath in SANCTIONED_CHANNELS
        if not in_channel and not ctx.relpath.startswith(_CONSENSUS_PREFIXES):
            return
        time_aliases: Set[str] = set()
        random_aliases: Set[str] = set()
        numpy_aliases: Set[str] = set()
        os_aliases: Set[str] = set()
        secrets_aliases: Set[str] = set()
        bare_banned: Dict[str, str] = {}  # local name -> origin description
        for node in ast.walk(ctx.tree):
            if isinstance(node, ast.Import):
                for a in node.names:
                    local = a.asname or a.name
                    if a.name == "time":
                        time_aliases.add(local)
                    elif a.name == "random":
                        random_aliases.add(local)
                    elif a.name == "numpy":
                        numpy_aliases.add(local)
                    elif a.name == "os":
                        os_aliases.add(local)
                    elif a.name == "secrets":
                        secrets_aliases.add(local)
            elif isinstance(node, ast.ImportFrom):
                for a in node.names:
                    local = a.asname or a.name
                    if node.module == "time" and a.name in _TIME_FNS:
                        bare_banned[local] = f"time.{a.name}"
                    elif node.module == "random":
                        bare_banned[local] = f"random.{a.name}"
                    elif node.module == "os" and a.name == "urandom":
                        bare_banned[local] = "os.urandom"
                    elif node.module == "secrets":
                        bare_banned[local] = f"secrets.{a.name}"
                    elif node.module == "numpy" and a.name == "random":
                        random_aliases.add(local)
        if in_channel:
            # the channel's wall-clock reads ARE the sanctioned channel;
            # only the entropy bans apply inside it
            time_aliases = set()
            bare_banned = {
                k: v for k, v in bare_banned.items()
                if not v.startswith("time.")
            }
        for node in ast.walk(ctx.tree):
            if isinstance(node, ast.Call):
                msg = self._call_verdict(
                    node, time_aliases, random_aliases, numpy_aliases,
                    os_aliases, secrets_aliases, bare_banned,
                )
                if msg:
                    yield Finding(
                        self.id, ctx.relpath, node.lineno, node.col_offset,
                        msg,
                    )
            elif in_channel:
                continue  # set-iteration ban stays consensus-only
            elif isinstance(node, (ast.For, ast.comprehension)):
                if _iterates_set(node.iter):
                    yield Finding(
                        self.id, ctx.relpath,
                        getattr(node, "lineno", node.iter.lineno),
                        getattr(node, "col_offset", node.iter.col_offset),
                        "iteration over a set is unordered — sort it (or "
                        "iterate an insertion-ordered dict) before bytes "
                        "derived from it can reach consensus",
                    )

    def _call_verdict(
        self, node, time_aliases, random_aliases, numpy_aliases,
        os_aliases, secrets_aliases, bare_banned,
    ) -> Optional[str]:
        f = node.func
        if isinstance(f, ast.Name):
            origin = bare_banned.get(f.id)
            if origin:
                return (
                    f"{origin} in a consensus module — route telemetry "
                    "timestamps through utils/telemetry clock(), entropy "
                    "through explicitly seeded channels"
                )
            return None
        if not isinstance(f, ast.Attribute):
            return None
        src = ast.unparse(f)
        head = src.split(".", 1)[0]
        if head in time_aliases and f.attr in _TIME_FNS and "." in src:
            return (
                f"{src}() reads the wall clock in a consensus module — "
                "use utils/telemetry clock() (telemetry-only channel) or "
                "carry an explicit allow"
            )
        if head in random_aliases:
            return f"{src}() draws nondeterministic randomness in a consensus module"
        if any(src.startswith(a + ".random.") for a in numpy_aliases):
            return (
                f"{src}() uses numpy randomness in a consensus module — "
                "seed it explicitly and carry an allow if intentional"
            )
        if head in os_aliases and f.attr == "urandom":
            return f"{src}() reads OS entropy in a consensus module"
        if head in secrets_aliases:
            return f"{src}() reads OS entropy in a consensus module"
        return None


def _iterates_set(it: ast.AST) -> bool:
    if isinstance(it, ast.Set):
        return True
    return (
        isinstance(it, ast.Call)
        and isinstance(it.func, ast.Name)
        and it.func.id == "set"
    )


# ---------------------------------------------------------------------------
# R4: hostpool-discipline
# ---------------------------------------------------------------------------


@register
class HostpoolDisciplineRule(Rule):
    id = "hostpool-discipline"
    summary = "nthreads comes from utils/hostpool, never a literal"
    doc = (
        "Flags nthreads=<int literal> at call sites and non-None literal "
        "defaults on nthreads parameters.  None means 'resolve from the "
        "process-wide pool' (utils/hostpool cpu_threads()); a hard-coded "
        "count either oversubscribes the pool or silently serializes — "
        "deliberate serial paths (nested pool workers) carry an allow."
    )

    def check(self, ctx: ModuleContext) -> Iterator[Finding]:
        for node in ast.walk(ctx.tree):
            if isinstance(node, ast.Call):
                for kw in node.keywords:
                    if (
                        kw.arg == "nthreads"
                        and isinstance(kw.value, ast.Constant)
                        and isinstance(kw.value.value, int)
                        and not isinstance(kw.value.value, bool)
                    ):
                        yield Finding(
                            self.id, ctx.relpath,
                            kw.value.lineno, kw.value.col_offset,
                            f"literal nthreads={kw.value.value} — thread "
                            "counts come from utils/hostpool (pass None to "
                            "resolve from the pool)",
                        )
            elif isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                yield from self._check_defaults(ctx, node)

    def _check_defaults(self, ctx, node) -> Iterator[Finding]:
        args = node.args
        pos = args.posonlyargs + args.args
        for arg, default in zip(pos[len(pos) - len(args.defaults):], args.defaults):
            if arg.arg == "nthreads" and _literal_int(default):
                yield Finding(
                    self.id, ctx.relpath, default.lineno, default.col_offset,
                    f"literal default nthreads={default.value} on "
                    f"{node.name}() — default to None and resolve via "
                    "utils/hostpool",
                )
        for arg, default in zip(args.kwonlyargs, args.kw_defaults):
            if default is not None and arg.arg == "nthreads" and _literal_int(default):
                yield Finding(
                    self.id, ctx.relpath, default.lineno, default.col_offset,
                    f"literal default nthreads={default.value} on "
                    f"{node.name}() — default to None and resolve via "
                    "utils/hostpool",
                )


def _literal_int(node: ast.AST) -> bool:
    return (
        isinstance(node, ast.Constant)
        and isinstance(node.value, int)
        and not isinstance(node.value, bool)
    )


# ---------------------------------------------------------------------------
# R5: sanctioned-retry
# ---------------------------------------------------------------------------

# the one module allowed to sleep in loops / implement retry primitives
_RETRY_SANCTIONED = "celestia_tpu_torch/utils/faults.py"

# exception names whose silent swallow is a finding (anything this broad
# hides real failures; narrower types document what is being tolerated)
_BROAD_EXCEPTIONS = {"Exception", "BaseException"}


@register
class SanctionedRetryRule(Rule):
    id = "sanctioned-retry"
    summary = "no silent exception swallows or hand-rolled sleep retry loops"
    doc = (
        "Outside utils/faults.py flags: (a) bare `except:`; (b) an "
        "`except Exception`/`except BaseException` handler whose body is "
        "only pass/continue — a silently swallowed failure (record it "
        "with faults.note(<point>, e) or re-raise); (c) a time.sleep "
        "call lexically inside a for/while loop — a hand-rolled retry/"
        "poll loop (use faults.RetryPolicy: seeded decorrelated-jitter "
        "backoff + deadline budget).  Deliberate pacing sleeps carry an "
        "allow with a reason."
    )

    def check(self, ctx: ModuleContext) -> Iterator[Finding]:
        if ctx.relpath == _RETRY_SANCTIONED:
            return
        sleep_names = _sleep_aliases(ctx.tree)
        for node in ast.walk(ctx.tree):
            if isinstance(node, ast.ExceptHandler):
                yield from self._check_handler(ctx, node)
            elif isinstance(node, ast.Call) and _is_sleep_call(
                node, sleep_names
            ):
                if any(
                    isinstance(anc, (ast.For, ast.While, ast.AsyncFor))
                    for anc in ctx.ancestors(node)
                ):
                    yield Finding(
                        self.id, ctx.relpath, node.lineno, node.col_offset,
                        "time.sleep inside a loop is a hand-rolled retry/"
                        "poll — use utils/faults.RetryPolicy (run/poll) "
                        "or carry an allow naming the pacing reason",
                    )

    def _check_handler(
        self, ctx: ModuleContext, node: ast.ExceptHandler
    ) -> Iterator[Finding]:
        if node.type is None:
            yield Finding(
                self.id, ctx.relpath, node.lineno, node.col_offset,
                "bare `except:` swallows KeyboardInterrupt/SystemExit too "
                "— name the exception type",
            )
            return
        if not _catches_broad(node.type):
            return
        if all(isinstance(s, (ast.Pass, ast.Continue)) for s in node.body):
            yield Finding(
                self.id, ctx.relpath, node.lineno, node.col_offset,
                "`except Exception` with a pass/continue body silently "
                "drops the failure — record it with "
                "faults.note(<point>, e) or re-raise",
            )


def _catches_broad(t: ast.AST) -> bool:
    if isinstance(t, ast.Name):
        return t.id in _BROAD_EXCEPTIONS
    if isinstance(t, ast.Attribute):
        return t.attr in _BROAD_EXCEPTIONS
    if isinstance(t, ast.Tuple):
        return any(_catches_broad(e) for e in t.elts)
    return False


def _sleep_aliases(tree: ast.Module) -> Set[str]:
    """Local names bound to time.sleep via `from time import sleep`."""
    out: Set[str] = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.ImportFrom) and node.module == "time":
            for a in node.names:
                if a.name == "sleep":
                    out.add(a.asname or a.name)
    return out


def _is_sleep_call(node: ast.Call, sleep_names: Set[str]) -> bool:
    f = node.func
    if isinstance(f, ast.Name):
        return f.id in sleep_names
    # <any alias>.sleep(...): time is routinely imported as _time; a
    # non-time object with a .sleep() method would be novel enough in
    # this tree to deserve the allow it would need
    return isinstance(f, ast.Attribute) and f.attr == "sleep"


# ---------------------------------------------------------------------------
# R6/R7/R8 live in their own modules (lock-order is a whole-program
# pass; host-sync/layering are the hot-path and architecture rules) —
# imported here so the registry sees them whenever the catalog loads.
# ---------------------------------------------------------------------------

from celestia_tpu_torch.lint import hotpath as _hotpath  # noqa: E402,F401
from celestia_tpu_torch.lint import lockorder as _lockorder  # noqa: E402,F401
