"""The port's lint (``celestia_tpu_torch.lint``) against the JAX lint.

* the port's tree lints clean with every rule (R6's
  ``specs/lock_hierarchy_torch.md`` drift check included) and the CLI
  exits 0;
* every fixture of tests/test_lint.py for R1-R6, R8 and the directive
  hygiene, with its paths and imports re-pointed from ``celestia_tpu`` to
  ``celestia_tpu_torch``, gives the same rule ids at the same lines under
  both lints (each JAX test runs as it is, its lint calls recorded);
* R7, re-homed for torch, fires on ``.item()``, ``.cpu()``,
  ``.tolist()``, ``.numpy()``, the scalar builtins and
  ``torch.cuda.synchronize()`` of a device tensor in ``da/``, ``ops/``
  and ``state/``, and stays quiet on host tensors, devprof fetch legs,
  values a bracket's ``done()`` drained and the sanctioned breakdown;
* ``--write-lock-hierarchy`` writes ``specs/lock_hierarchy_torch.md``
  byte for byte.
"""

import contextlib
import inspect
import io
import json
import re
import textwrap
from pathlib import Path

import pytest

import test_lint as jax_lint_tests
from celestia_tpu.lint import lint_program as jax_lint_program
from celestia_tpu_torch.lint import (
    REGISTRY,
    failing,
    lint_program,
    lint_source,
    resolve_rules,
    run_lint,
)
from celestia_tpu_torch.lint import hotpath, lockorder
from celestia_tpu_torch.lint.__main__ import main

REPO = Path(__file__).resolve().parent.parent

resolve_rules(None)


# --- the tree ------------------------------------------------------------------

_FULL_RUN: dict = {}


def _full_tree_run():
    if not _FULL_RUN:
        from celestia_tpu_torch.lint import LintStats

        stats = LintStats()
        _FULL_RUN["findings"] = run_lint(stats=stats)
        _FULL_RUN["stats"] = stats
    return _FULL_RUN["findings"], _FULL_RUN["stats"]


def test_port_tree_lints_clean_with_all_rules():
    findings, stats = _full_tree_run()
    bad = failing(findings)
    assert not bad, "celint findings:\n" + "\n".join(f.format() for f in bad)
    assert stats.files >= 100
    assert set(stats.to_dict()["rules"]) >= set(REGISTRY)
    for f in findings:
        assert f.suppress_reason, f.format()


def test_cli_exits_0_on_the_port_and_1_on_a_finding(tmp_path, monkeypatch):
    from celestia_tpu_torch.lint import __main__ as cli

    # the default tree's findings are the shared full run's (one pass of
    # ~10 s serves both tests); paths given on the command line lint anew
    monkeypatch.setattr(
        cli, "run_lint",
        lambda paths, rules, stats=None: (
            _full_tree_run()[0] if paths is None and rules is None
            else run_lint(paths, rules, stats=stats)
        ),
    )
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert main([]) == 0
    assert buf.getvalue().splitlines()[-1].endswith("clean")
    bad = tmp_path / "bad.py"
    bad.write_text("try:\n    pass\nexcept:\n    pass\n")
    with contextlib.redirect_stdout(io.StringIO()):
        assert main([str(bad), "--format", "json"]) == 1
        assert main([str(bad), "--rules", "no-such-rule"]) == 2
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert main(["celestia_tpu_torch/lint", "--format", "sarif"]) == 0
    assert json.loads(buf.getvalue())["version"] == "2.1.0"


def test_device_plane_carries_no_allow_pragma():
    src = (REPO / "celestia_tpu_torch" / "da" / "device_plane.py").read_text()
    assert "celint: allow" not in src


def test_write_lock_hierarchy_gives_the_committed_file(tmp_path, monkeypatch):
    out = tmp_path / "lock_hierarchy_torch.md"
    # an absolute HIERARCHY_PATH: REPO_ROOT / it is the temporary file
    monkeypatch.setattr(lockorder, "HIERARCHY_PATH", str(out))
    with contextlib.redirect_stdout(io.StringIO()):
        assert main(["--write-lock-hierarchy"]) == 0
    assert out.read_bytes() == (REPO / "specs" / "lock_hierarchy_torch.md").read_bytes()
    # the port's own locks are in it, under the port's paths
    text = out.read_text()
    assert "node/gossip.py::GossipEngine" in text
    assert "celestia_tpu_torch/kernels/__init__.py" in text
    assert "python -m celestia_tpu_torch.lint --write-lock-hierarchy" in text


# --- R1-R6, R8: the JAX fixtures under both lints ---------------------------------


def _lint_tests():
    """The JAX tests of R1-R6, R8 and the directive hygiene that lint a
    fixture (R7's body differs: its cases are below)."""
    names = []
    for name, fn in vars(jax_lint_tests).items():
        if not name.startswith("test_") or name.startswith("test_r7"):
            continue
        src = inspect.getsource(fn)
        if re.search(r"\b(_lint|_lint_pair|lint_source|lint_program)\(", src):
            names.append(name)
    return sorted(names)


def _repoint(text: str) -> str:
    return re.sub(r"\bcelestia_tpu\b", "celestia_tpu_torch", text)


def _key(findings):
    return sorted((f.rule, f.path, f.line, f.suppressed) for f in findings)


@pytest.mark.parametrize("name", _lint_tests())
def test_port_lint_agrees_with_jax_on_the_fixture(name, monkeypatch):
    calls = []

    def recording_program(sources, rules=None, **kw):
        out = jax_lint_program(sources, rules, **kw)
        calls.append((dict(sources), rules, kw, out))
        return out

    def recording_source(source, relpath, rules=None):
        return recording_program({relpath: source}, rules)

    monkeypatch.setattr(jax_lint_tests, "lint_program", recording_program)
    monkeypatch.setattr(jax_lint_tests, "lint_source", recording_source)
    getattr(jax_lint_tests, name)()  # the JAX test itself, as it is
    assert calls, f"{name} linted nothing"
    for sources, rules, kw, jax_out in calls:
        port_sources = {_repoint(p): _repoint(s) for p, s in sources.items()}
        port_out = lint_program(port_sources, rules, **kw)
        assert _key(port_out) == [
            (r, _repoint(p), line, sup) for r, p, line, sup in _key(jax_out)
        ], name


# --- R7 re-homed for torch --------------------------------------------------------


def _r7(src: str, relpath: str):
    return [
        (f.line, f.message.split(" ")[0])
        for f in lint_source(textwrap.dedent(src), relpath, ["r7"])
        if not f.suppressed
    ]


R7_BAD = """
    import numpy as np
    import torch

    from celestia_tpu_torch.ops import rs


    def bad_item(n, dev):
        t = torch.zeros(n, dtype=torch.int32, device=dev)
        return t.item()


    def bad_cpu(sq, dev):
        out = sq.to(dev)
        return out.cpu()


    def bad_tolist(sq):
        eds = rs.extend_batched_cuda(sq, "leopard-ff8")
        return eds[0].tolist()


    def bad_synchronize(sq):
        eds = sq.cuda()
        torch.cuda.synchronize()
        return eds


    def bad_numpy_and_scalars(x, dev):
        t = torch.as_tensor(x, device=dev)
        flags = torch.stack([t, t]).any()
        return t.numpy(), bool(flags), int(t.sum()), np.asarray(t)
"""

# line of each finding in R7_BAD (dedented) -> the form it names
R7_BAD_WANT = [
    (10, ".item()"), (15, ".cpu()"), (20, ".tolist()"),
    (25, "torch.cuda.synchronize()"),
    (32, ".numpy()"), (32, "bool(flags)"), (32, "int(t.sum())"),
    (32, "np.asarray(t)"),
]


@pytest.mark.parametrize("pkg", ["da", "ops", "state"])
def test_r7_fires_on_torch_host_syncs_of_device_tensors(pkg):
    got = sorted(_r7(R7_BAD, f"celestia_tpu_torch/{pkg}/fixture.py"))
    assert got == sorted(R7_BAD_WANT), got


def test_r7_fires_on_event_and_stream_synchronize():
    src = """
        import torch


        def wait(ev, dev):
            ev.synchronize()
            torch.cuda.current_stream(dev).synchronize()
    """
    assert [line for line, _ in _r7(src, "celestia_tpu_torch/ops/fixture.py")] == [6, 7]


def test_r7_scoped_to_the_hot_prefixes():
    for pkg in ("node", "utils", "client", "parallel"):
        assert _r7(R7_BAD, f"celestia_tpu_torch/{pkg}/fixture.py") == []
    # the JAX tree's paths are not the port's
    assert _r7(R7_BAD, "celestia_tpu/da/fixture.py") == []


R7_GOOD = """
    import numpy as np
    import torch

    from celestia_tpu_torch.ops import nmt
    from celestia_tpu_torch.utils import devprof


    def host_tensors(x):
        t = torch.from_numpy(x)
        c = torch.zeros(4, dtype=torch.uint8, device="cpu")
        u = t.to(torch.int32)
        return t.item(), c.tolist(), u.numpy(), int(t.sum()), t.cpu()


    def fetch_leg(sq, dev):
        d = devprof.dispatch("fixture", dev)
        out = d.done(nmt.grid_levels(sq.to(dev)))
        return devprof.fetch("roots", out).numpy()


    def drained(sq, dev):
        d = devprof.dispatch("fixture", dev)
        out = nmt.grid_levels(sq.to(dev))
        d.done(out)
        return out.cpu().numpy()


    def bracketed_wrapper(eds):
        return nmt.eds_nmt_roots_device(eds).cpu().numpy()


    def attribute_chains(self):
        return self._tensor.cpu().numpy(), self.t.shape[0]


    def host_numbers(sq, dev):
        t = sq.to(dev)
        return int(t.numel()), int(t.shape[0]), int(t.size(0))
"""


def test_r7_quiet_on_host_tensors_fetch_legs_and_drained_values():
    assert _r7(R7_GOOD, "celestia_tpu_torch/da/fixture.py") == []


def test_r7_sanctioned_breakdown_is_exempt():
    assert ("celestia_tpu_torch/da/dah.py", "extend_and_header_breakdown") in (
        hotpath.HOT_SYNC_SANCTIONED
    )
    src = """
        import torch


        def extend_and_header_breakdown(sq, dev):
            t = sq.to(dev)
            torch.cuda.synchronize(dev)
            return t.cpu().numpy()


        def extend_and_header(sq, dev):
            t = sq.to(dev)
            return t.cpu().numpy()
    """
    assert _r7(src, "celestia_tpu_torch/da/dah.py") == [(13, ".cpu()")]


def test_r7_allow_with_reason_suppresses():
    src = """
        import torch


        def sync_point(dev):
            # celint: allow(host-sync) — fixture: deliberate timing boundary
            torch.cuda.synchronize(dev)
    """
    out = lint_source(textwrap.dedent(src), "celestia_tpu_torch/ops/fixture.py", ["r7"])
    assert [f.suppressed for f in out] == [True]


def test_r7_derives_the_kernel_wrappers_from_the_ops_modules():
    table = hotpath.launch_functions()
    assert "extend_batched_cuda" in table["celestia_tpu_torch/ops/rs.py"]
    assert "das_cell_gather_cuda" in table["celestia_tpu_torch/ops/gather.py"]
    assert "sha256_cuda" in table["celestia_tpu_torch/ops/sha256.py"]
    # host-returning functions are not wrappers
    assert "sha256_np" not in table["celestia_tpu_torch/ops/sha256.py"]
    assert "eds_nmt_roots_host" not in table["celestia_tpu_torch/ops/nmt.py"]
    # a wrapper of the module under check that exists only in memory
    src = """
        from celestia_tpu_torch import kernels


        def my_cuda(x):
            out = x.new_empty(x.shape)
            kernels.launch("k", x.device, x, out)
            return out


        def caller(x):
            return my_cuda(x).tolist()
    """
    assert _r7(src, "celestia_tpu_torch/ops/fixture.py") == [(12, ".tolist()")]


def test_r8_places_the_ports_own_modules():
    layers = hotpath.LAYERS
    assert layers["appconsts"] < layers["kernels"] < layers["utils"] < layers["ops"]
    assert layers["lint"] < layers["tools"]
    # ops/gather may import kernels; kernels may import no package module
    ok = "from celestia_tpu_torch import kernels\n"
    assert lint_source(ok, "celestia_tpu_torch/ops/gather.py", ["r8"]) == []
    assert lint_source(ok, "celestia_tpu_torch/utils/devprof.py", ["r8"]) == []
    back = "from celestia_tpu_torch.utils import tracing\n"
    assert [f.rule for f in lint_source(back, "celestia_tpu_torch/kernels/__init__.py", ["r8"])] == ["layering"]
    # parallel/collectives may import ops; ops may not import parallel
    assert lint_source("from celestia_tpu_torch.ops import rs\n",
                       "celestia_tpu_torch/parallel/collectives.py", ["r8"]) == []
    assert [f.rule for f in lint_source("from celestia_tpu_torch.parallel import collectives\n",
                                        "celestia_tpu_torch/ops/rs.py", ["r8"])] == ["layering"]
    # the tools drive everything, the lint included
    assert lint_source("from celestia_tpu_torch.lint.engine import run_lint\n",
                       "celestia_tpu_torch/tools/device_resident_smoke.py", ["r8"]) == []
