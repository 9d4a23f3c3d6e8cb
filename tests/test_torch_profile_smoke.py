"""The port's profile-smoke twin (celestia_tpu_torch/tools/
profile_smoke.py) in process on the CPU, one test a leg: the node leg (a
traced block under a torch.profiler capture; on the CPU the device-track
leg drives the plane directly on the committed square, its data root held
to the block's) and the CLI leg (a stalled validator process, ``query
timeseries`` / ``query alerts`` and the plain-HTTP scrape)."""

import json

import pytest

from _torch_common import fresh_port_faults  # noqa: F401 (fixture)
from celestia_tpu_torch import tools
from celestia_tpu_torch.tools import profile_smoke

pytestmark = pytest.mark.usefixtures("fresh_port_faults")


def _out(capsys):
    return [json.loads(x) for x in capsys.readouterr().out.strip().splitlines()
            if x.startswith("{")]


def test_profile_node_leg_on_the_cpu(capsys):
    assert tools.run_leg(profile_smoke.LEGS, "node", "cpu") == 0
    out = _out(capsys)[-1]
    assert out["profile_smoke"] == "ok" and out["device_leg"] == "plane_extend"
    assert out["device_tracks"] == ["device:cpu:0"] and out["capture_events"] > 0
    assert "extend_levels" in out["kernels"] and "degradations" in out["alerts_fired"]


def test_profile_cli_leg_on_the_cpu(capsys):
    assert tools.run_leg(profile_smoke.LEGS, "cli", "cpu") == 0
    out = _out(capsys)[-1]
    assert out["profile_smoke_node"] == "ok" and out["snapshots"] >= 2
    assert out["alerts_fired"] == ["smoke_height_stall"]
