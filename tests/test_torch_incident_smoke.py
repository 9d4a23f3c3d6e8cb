"""The port's incident-smoke twin (celestia_tpu_torch/tools/
incident_smoke.py) in process on the CPU, one test a leg: the armed node
(host sampler, flight recorder, a stall rule: the bundle, its manifest,
trace and folded stacks, /healthz degraded) and the disarmed node (no
flight dir, a disabled profiler, <1% overhead)."""

import json

import pytest

from _torch_common import fresh_port_faults  # noqa: F401 (fixture)
from celestia_tpu_torch import tools
from celestia_tpu_torch.tools import incident_smoke

pytestmark = pytest.mark.usefixtures("fresh_port_faults")


def _out(capsys):
    return [json.loads(x) for x in capsys.readouterr().out.strip().splitlines()
            if x.startswith("{")]


def test_incident_armed_leg_on_the_cpu(capsys):
    assert tools.run_leg(incident_smoke.LEGS, "armed", "cpu") == 0
    out = _out(capsys)[-1]
    assert out["incident_smoke"] == "ok" and out["device"] == "cpu"
    assert out["healthz"] == "degraded" and out["sample_events"] > 0


def test_incident_disarmed_leg_on_the_cpu(capsys):
    assert tools.run_leg(incident_smoke.LEGS, "disarmed", "cpu") == 0
    out = _out(capsys)[-1]
    assert out["incident_smoke_disarmed"] == "ok" and out["incidents"] == 0
