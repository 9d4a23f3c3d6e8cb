"""The port's critpath-smoke twin (celestia_tpu_torch/tools/
critpath_smoke.py) in process on the CPU, one test a leg: the mesh leg
(two traced validator processes, one coordinated block, the analyzer over
the merged doc, scorecards, the waterfall and the report CLI) and the SLO
leg (an impossible block budget trips the flight recorder and /healthz);
and its companion critpath_report, whose report of the mesh leg's merged
trace is held to the JAX tool's on the same file."""

import contextlib
import importlib.util
import io
import json

import pytest
from pathlib import Path

from _torch_common import fresh_port_faults  # noqa: F401 (fixture)
from celestia_tpu_torch import tools
from celestia_tpu_torch.tools import critpath_report, critpath_smoke

pytestmark = pytest.mark.usefixtures("fresh_port_faults")

REPO = Path(__file__).resolve().parents[1]


def _out(capsys):
    return [json.loads(x) for x in capsys.readouterr().out.strip().splitlines()
            if x.startswith("{")]


def _report(main, path):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert main(["--trace", path, "--json"]) == 0
    return json.loads(buf.getvalue())


def test_critpath_mesh_leg_on_the_cpu_and_the_report_matches_jax(capsys):
    assert tools.run_leg(critpath_smoke.LEGS, "mesh", "cpu") == 0
    out = _out(capsys)[-1]
    assert out["critpath_smoke_mesh"] == "ok" and out["device"] == "cpu"
    assert out["end"] == "rpc.cons_commit" and out["propagation_delay_ms"] > 0
    spec = importlib.util.spec_from_file_location(
        "jax_critpath_report", REPO / "tools" / "critpath_report.py")
    jax_report = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(jax_report)
    assert _report(critpath_report.main, out["trace_file"]) == _report(
        jax_report.main, out["trace_file"])


def test_critpath_slo_leg_on_the_cpu(capsys):
    assert tools.run_leg(critpath_smoke.LEGS, "slo", "cpu") == 0
    out = _out(capsys)[-1]
    assert out["critpath_smoke_slo"] == "ok" and out["healthz"] == "degraded"
    assert "block_e2e_slo" in out["reason"]
