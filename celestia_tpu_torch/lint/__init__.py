"""celint: repo-specific concurrency & determinism static analysis, on the port.

The port's copy of ``celestia_tpu/lint/``, re-pointed at ``celestia_tpu_torch``:
the default tree, the sanctioned modules, the rules' scopes, R8's layers
and R6's hierarchy (``specs/lock_hierarchy_torch.md``) name the port, and
R7 (hotpath.py) knows torch's device values and host syncs.
``python -m celestia_tpu_torch.lint`` runs the rule catalog over the package;
tests/test_torch_lint.py runs it as a tier-1 gate.  See engine.py for the
machinery, rules.py for R1-R4, specs/static_analysis.md for the docs.
"""

from celestia_tpu_torch.lint.engine import (  # noqa: F401
    ALIASES,
    Finding,
    LintStats,
    ModuleContext,
    Program,
    ProgramRule,
    REGISTRY,
    Rule,
    failing,
    lint_program,
    lint_source,
    register,
    render_human,
    render_json,
    render_sarif,
    resolve_rules,
    run_lint,
)
