"""celint engine: directive parsing, module contexts, rule registry, runner.

The port's copy of ``celestia_tpu/lint/engine.py``; its default tree is the
``celestia_tpu_torch`` package.

celint is the repo's own static analyzer: a consensus state machine whose
hot path is aggressively concurrent (process-wide hostpool, overlapped
native extend, shared bounded LRUs) cannot rely on reviewer memory to
keep the safety invariants of the host pipeline true — each parallelization is only
admissible while its invariants hold, and those invariants are exactly
the kind of thing that drifts one innocent edit at a time (the unlocked
commitment cache shipped that way once).  The rules live in
``rules.py``; this module is the machinery they share.

Directive syntax (comments, parsed with ``tokenize`` so strings that
merely LOOK like directives — e.g. lint test fixtures — never register):

``# celint: allow(<rule>[, <rule>...]) — <reason>``
    Suppress findings of the named rule(s).  A directive on a statement
    line suppresses findings on that line; a directive on a comment-only
    line suppresses findings on the next statement line (so multi-line
    calls can carry the allow inside their parentheses).  The reason is
    MANDATORY: an allow without one is itself a finding
    (``bad-suppression``), and an allow that suppresses nothing is dead
    weight and reported too (``unused-suppression``) — suppressions must
    stay explained and alive, per the audit-sweep contract.

``# celint: guarded-by(<lock>)``
    Declares that the variable assigned on this line (a module global or
    a ``self.<attr>``) may only be MUTATED while ``<lock>`` is held —
    i.e. lexically inside ``with <lock>:`` — enforced by the
    ``guarded-by`` rule.  Helper methods whose name ends in ``_locked``
    are exempt by convention: they document that the CALLER holds the
    lock (utils/lru.py's ``_insert_locked``).

Adding a rule: subclass :class:`Rule`, set ``id``/``summary``/``doc``,
implement ``check(ctx)`` yielding :class:`Finding`, and decorate with
``@register``.  Import it from ``rules.py`` so the registry sees it.
Whole-program rules (lock-order needs every module's acquisition graph
at once) subclass :class:`ProgramRule` instead and implement
``check_program(program)`` over the :class:`Program` context.
See specs/static_analysis.md for the catalog and worked examples.
"""

from __future__ import annotations

import ast
import io
import json
import re
import time
import tokenize
from dataclasses import dataclass, field
from pathlib import Path
from typing import Dict, Iterable, Iterator, List, Optional, Tuple

REPO_ROOT = Path(__file__).resolve().parents[2]

# em-dash, hyphen or colon may introduce the reason
_DIRECTIVE_RE = re.compile(
    r"celint:\s*(?P<kind>allow|guarded-by)\s*"
    r"\((?P<args>[^)]*)\)\s*(?:[—:-]+\s*(?P<reason>.*\S))?"
)

# findings the engine itself emits about directive hygiene
BAD_SUPPRESSION = "bad-suppression"
UNUSED_SUPPRESSION = "unused-suppression"
PARSE_ERROR = "parse-error"


@dataclass
class Finding:
    rule: str
    path: str  # repo-relative
    line: int
    col: int
    message: str
    suppressed: bool = False
    suppress_reason: str = ""

    def format(self) -> str:
        tag = " (suppressed)" if self.suppressed else ""
        return f"{self.path}:{self.line}:{self.col}: [{self.rule}] {self.message}{tag}"

    def to_dict(self) -> dict:
        return {
            "rule": self.rule,
            "path": self.path,
            "line": self.line,
            "col": self.col,
            "message": self.message,
            "suppressed": self.suppressed,
            "suppress_reason": self.suppress_reason,
        }


@dataclass
class AllowDirective:
    line: int  # line the directive appears on
    target_line: int  # line whose findings it suppresses
    rules: Tuple[str, ...]
    reason: str
    used: bool = False


@dataclass
class GuardDirective:
    line: int  # line of the annotated assignment
    target_line: int
    lock: str  # normalized source of the guarding lock expression


class ModuleContext:
    """Everything a rule needs about one source file: AST, directives,
    parent links, and the repo-relative path rules scope on."""

    def __init__(self, relpath: str, source: str):
        self.relpath = relpath
        self.source = source
        self.lines = source.splitlines()
        self.tree = ast.parse(source)
        self.parents: Dict[ast.AST, ast.AST] = {}
        for node in ast.walk(self.tree):
            for child in ast.iter_child_nodes(node):
                self.parents[child] = node
        self.allows: List[AllowDirective] = []
        self.guards: List[GuardDirective] = []
        self.directive_errors: List[Finding] = []
        self._parse_directives()

    # -- directives ----------------------------------------------------

    def _next_statement_line(self, line: int) -> int:
        """First line at or after ``line`` that is not blank/comment-only
        (where a comment-line directive's findings will anchor)."""
        i = line - 1
        while i < len(self.lines):
            stripped = self.lines[i].strip()
            if stripped and not stripped.startswith("#"):
                return i + 1
            i += 1
        return line

    def _parse_directives(self) -> None:
        try:
            tokens = tokenize.generate_tokens(io.StringIO(self.source).readline)
            comments = [
                (t.start[0], t.string)
                for t in tokens
                if t.type == tokenize.COMMENT
            ]
        except tokenize.TokenError:
            comments = []
        for line, text in comments:
            m = _DIRECTIVE_RE.search(text)
            if m is None:
                if "celint:" in text:
                    self.directive_errors.append(
                        Finding(
                            BAD_SUPPRESSION, self.relpath, line, 0,
                            f"unparseable celint directive: {text.strip()!r}",
                        )
                    )
                continue
            kind = m.group("kind")
            args = [a.strip() for a in m.group("args").split(",") if a.strip()]
            reason = (m.group("reason") or "").strip()
            own_line_is_comment = (
                self.lines[line - 1].strip().startswith("#")
                if line - 1 < len(self.lines)
                else False
            )
            target = self._next_statement_line(line) if own_line_is_comment else line
            if kind == "allow":
                if not args:
                    self.directive_errors.append(
                        Finding(
                            BAD_SUPPRESSION, self.relpath, line, 0,
                            "allow() names no rule",
                        )
                    )
                    continue
                if not reason:
                    self.directive_errors.append(
                        Finding(
                            BAD_SUPPRESSION, self.relpath, line, 0,
                            f"allow({', '.join(args)}) without a reason — "
                            "every suppression must explain itself",
                        )
                    )
                    continue
                self.allows.append(
                    AllowDirective(line, target, tuple(args), reason)
                )
            else:  # guarded-by
                if len(args) != 1:
                    self.directive_errors.append(
                        Finding(
                            BAD_SUPPRESSION, self.relpath, line, 0,
                            "guarded-by() takes exactly one lock expression",
                        )
                    )
                    continue
                self.guards.append(
                    GuardDirective(line, target, normalize_expr(args[0]))
                )

    def allow_for(self, rule: str, line: int) -> Optional[AllowDirective]:
        for d in self.allows:
            if line in (d.line, d.target_line) and rule in d.rules:
                return d
        return None

    # -- AST helpers ---------------------------------------------------

    def ancestors(self, node: ast.AST) -> Iterator[ast.AST]:
        cur = self.parents.get(node)
        while cur is not None:
            yield cur
            cur = self.parents.get(cur)

    def held_locks(self, node: ast.AST) -> List[str]:
        """Normalized context exprs of every ``with`` enclosing ``node``."""
        out: List[str] = []
        for anc in self.ancestors(node):
            if isinstance(anc, ast.With):
                for item in anc.items:
                    out.append(normalize_expr(ast.unparse(item.context_expr)))
        return out

    def enclosing_functions(self, node: ast.AST) -> List[str]:
        return [
            anc.name
            for anc in self.ancestors(node)
            if isinstance(anc, (ast.FunctionDef, ast.AsyncFunctionDef))
        ]


def normalize_expr(text: str) -> str:
    return re.sub(r"\s+", "", text)


# -- rule registry -----------------------------------------------------


class Rule:
    id: str = ""
    summary: str = ""
    doc: str = ""

    def check(self, ctx: ModuleContext) -> Iterator[Finding]:
        raise NotImplementedError


class Program:
    """Whole-program context: every module's :class:`ModuleContext` plus
    run-scope facts program rules need (whether this run covers the
    default full package, so drift checks only fire on complete views)."""

    def __init__(self, contexts: List[ModuleContext], full_tree: bool = False):
        self.contexts = contexts
        self.by_path: Dict[str, ModuleContext] = {
            c.relpath: c for c in contexts
        }
        self.full_tree = full_tree


class ProgramRule(Rule):
    """A rule that needs every module at once (cross-module lock order).
    ``check`` is never called; the runner calls ``check_program``."""

    def check(self, ctx: ModuleContext) -> Iterator[Finding]:
        return iter(())

    def check_program(self, program: Program) -> Iterator[Finding]:
        raise NotImplementedError


REGISTRY: Dict[str, Rule] = {}

# short aliases accepted by --rules (the catalog's R1-R8 numbering)
ALIASES = {
    "r1": "guarded-by",
    "r2": "no-handrolled-cache",
    "r3": "consensus-determinism",
    "r4": "hostpool-discipline",
    "r5": "sanctioned-retry",
    "r6": "lock-order",
    "r7": "host-sync",
    "r8": "layering",
}


def register(cls):
    rule = cls()
    if not rule.id:
        raise ValueError(f"rule {cls.__name__} has no id")
    if rule.id in REGISTRY:
        raise ValueError(f"duplicate rule id {rule.id}")
    REGISTRY[rule.id] = rule
    return cls


def resolve_rules(names: Optional[Iterable[str]]) -> List[Rule]:
    import celestia_tpu_torch.lint.rules  # noqa: F401 — populate REGISTRY

    if names is None:
        return list(REGISTRY.values())
    out: List[Rule] = []
    for n in names:
        rid = ALIASES.get(n.lower(), n)
        if rid not in REGISTRY:
            raise KeyError(
                f"unknown rule {n!r} (known: {', '.join(sorted(REGISTRY))})"
            )
        out.append(REGISTRY[rid])
    return out


# -- runner ------------------------------------------------------------


class LintStats:
    """Per-rule wall time + finding counts for ``--stats`` and bench's
    ``extras.lint_stats`` — the whole-program pass must stay a watched
    number, not a silently growing tax on tier-1."""

    def __init__(self):
        self.rules: Dict[str, dict] = {}
        self.files = 0
        self.total_wall_ms = 0.0

    def add(self, rule_id: str, wall_s: float) -> None:
        rec = self.rules.setdefault(
            rule_id, {"wall_ms": 0.0, "findings": 0, "suppressed": 0}
        )
        rec["wall_ms"] += wall_s * 1000.0

    def count(self, findings: Iterable[Finding]) -> None:
        for f in findings:
            rec = self.rules.setdefault(
                f.rule, {"wall_ms": 0.0, "findings": 0, "suppressed": 0}
            )
            if f.suppressed:
                rec["suppressed"] += 1
            else:
                rec["findings"] += 1

    def to_dict(self) -> dict:
        return {
            "files": self.files,
            "total_wall_ms": round(self.total_wall_ms, 3),
            "rules": {
                rid: {
                    "wall_ms": round(rec["wall_ms"], 3),
                    "findings": rec["findings"],
                    "suppressed": rec["suppressed"],
                }
                for rid, rec in sorted(self.rules.items())
            },
        }


def _mark_allow(ctx: Optional[ModuleContext], f: Finding) -> Finding:
    if ctx is not None:
        allow = ctx.allow_for(f.rule, f.line)
        if allow is not None:
            allow.used = True
            f.suppressed = True
            f.suppress_reason = allow.reason
    return f


def lint_program(
    sources: Dict[str, str],
    rules: Optional[Iterable[str]] = None,
    *,
    full_tree: bool = False,
    stats: Optional[LintStats] = None,
) -> List[Finding]:
    """Lint a set of ``{relpath: source}`` modules as ONE program:
    per-module rules see each file, program rules (lock-order) see the
    whole set.  The entry point for both the CLI and the cross-module
    test fixtures."""
    t_start = time.perf_counter()
    active = resolve_rules(rules)
    findings: List[Finding] = []
    contexts: List[ModuleContext] = []
    for relpath, source in sorted(sources.items()):
        try:
            ctx = ModuleContext(relpath, source)
        except SyntaxError as e:
            findings.append(
                Finding(
                    PARSE_ERROR, relpath, e.lineno or 0, e.offset or 0,
                    f"syntax error: {e.msg}",
                )
            )
            continue
        contexts.append(ctx)
        findings.extend(ctx.directive_errors)
    program = Program(contexts, full_tree=full_tree)
    enabled = {r.id for r in active}
    for rule in active:
        t0 = time.perf_counter()
        if isinstance(rule, ProgramRule):
            for f in rule.check_program(program):
                findings.append(_mark_allow(program.by_path.get(f.path), f))
        else:
            for ctx in contexts:
                for f in rule.check(ctx):
                    findings.append(_mark_allow(ctx, f))
        if stats is not None:
            stats.add(rule.id, time.perf_counter() - t0)
    for ctx in contexts:
        for d in ctx.allows:
            if not d.used and any(r in enabled for r in d.rules):
                findings.append(
                    Finding(
                        UNUSED_SUPPRESSION, ctx.relpath, d.line, 0,
                        f"allow({', '.join(d.rules)}) suppresses nothing — "
                        "remove it or re-justify it",
                    )
                )
    findings.sort(key=lambda f: (f.path, f.line, f.col, f.rule))
    if stats is not None:
        stats.files = len(sources)
        stats.total_wall_ms = (time.perf_counter() - t_start) * 1000.0
        stats.count(findings)
    return findings


def lint_source(
    source: str, relpath: str, rules: Optional[Iterable[str]] = None
) -> List[Finding]:
    """Lint one source text as if it lived at ``relpath`` (repo-relative,
    forward slashes).  The entry point the single-module fixtures use."""
    return lint_program({relpath: source}, rules)


def iter_py_files(paths: Iterable[Path]) -> Iterator[Path]:
    for p in paths:
        p = Path(p)
        if p.is_file() and p.suffix == ".py":
            yield p
        elif p.is_dir():
            for sub in sorted(p.rglob("*.py")):
                if "__pycache__" in sub.parts or ".git" in sub.parts:
                    continue
                yield sub


def run_lint(
    paths: Optional[Iterable[Path]] = None,
    rules: Optional[Iterable[str]] = None,
    *,
    stats: Optional[LintStats] = None,
) -> List[Finding]:
    """Lint files/directories (default: the celestia_tpu_torch package, which
    is the only run shape the whole-program drift checks fire on)."""
    full_tree = paths is None
    if paths is None:
        paths = [REPO_ROOT / "celestia_tpu_torch"]
    sources: Dict[str, str] = {}
    for path in iter_py_files(paths):
        try:
            rel = str(path.resolve().relative_to(REPO_ROOT))
        except ValueError:
            rel = str(path)
        sources[rel.replace("\\", "/")] = path.read_text()
    return lint_program(sources, rules, full_tree=full_tree, stats=stats)


def failing(findings: Iterable[Finding]) -> List[Finding]:
    """The findings that make a lint run exit non-zero: everything not
    suppressed (directive-hygiene findings are never suppressible)."""
    return [f for f in findings if not f.suppressed]


def render_human(findings: List[Finding], show_suppressed: bool = False) -> str:
    shown = [f for f in findings if show_suppressed or not f.suppressed]
    lines = [f.format() for f in shown]
    bad = len(failing(findings))
    sup = sum(1 for f in findings if f.suppressed)
    lines.append(
        f"celint: {bad} finding(s), {sup} suppressed"
        + ("" if bad else " — clean")
    )
    return "\n".join(lines)


def render_json(
    findings: List[Finding], stats: Optional[LintStats] = None
) -> str:
    doc = {
        "findings": [f.to_dict() for f in findings],
        "failing": len(failing(findings)),
        "suppressed": sum(1 for f in findings if f.suppressed),
    }
    if stats is not None:
        doc["stats"] = stats.to_dict()
    return json.dumps(doc, indent=2)


def render_sarif(findings: List[Finding]) -> str:
    """SARIF 2.1.0 — the machine-readable format CI annotators ingest.
    Rule ids are the stable celint ids; suppressed findings carry a
    ``suppressions`` entry (state ``accepted``) instead of vanishing, so
    an auditor sees the allow AND its reason in the same document."""
    rule_ids = sorted({f.rule for f in findings})
    import celestia_tpu_torch.lint.rules  # noqa: F401 — populate REGISTRY

    known = dict(REGISTRY)
    sarif_rules = []
    for rid in rule_ids:
        rule = known.get(rid)
        desc = rule.summary if rule is not None else rid
        sarif_rules.append(
            {
                "id": rid,
                "shortDescription": {"text": desc},
            }
        )
    results = []
    for f in findings:
        result = {
            "ruleId": f.rule,
            "level": "warning" if f.suppressed else "error",
            "message": {"text": f.message},
            "locations": [
                {
                    "physicalLocation": {
                        "artifactLocation": {"uri": f.path},
                        "region": {
                            "startLine": max(1, f.line),
                            "startColumn": max(1, f.col + 1),
                        },
                    }
                }
            ],
        }
        if f.suppressed:
            result["suppressions"] = [
                {
                    "kind": "inSource",
                    "status": "accepted",
                    "justification": f.suppress_reason,
                }
            ]
        results.append(result)
    return json.dumps(
        {
            "$schema": (
                "https://raw.githubusercontent.com/oasis-tcs/sarif-spec/"
                "master/Schemata/sarif-schema-2.1.0.json"
            ),
            "version": "2.1.0",
            "runs": [
                {
                    "tool": {
                        "driver": {
                            "name": "celint",
                            "informationUri": "specs/static_analysis.md",
                            "rules": sarif_rules,
                        }
                    },
                    "results": results,
                }
            ],
        },
        indent=2,
    )
