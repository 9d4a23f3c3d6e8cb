"""The port's trace-smoke twin (celestia_tpu_torch/tools/trace_smoke.py)
in process on the CPU: the one-node leg and the two-process cluster leg
(two ``python -m celestia_tpu_torch.cli start --validator`` nodes, a
schema-valid merged trace with cross-node flows, prepare and process on
different pids); and its companion trace_merge, whose merged document is
held to the JAX tool's on the same inputs."""

import importlib.util
import json

import pytest
from pathlib import Path

from _torch_common import fresh_port_faults  # noqa: F401 (fixture)
from celestia_tpu_torch.tools import trace_merge, trace_smoke

pytestmark = pytest.mark.usefixtures("fresh_port_faults")

REPO = Path(__file__).resolve().parents[1]


def _jax_tool(name):
    spec = importlib.util.spec_from_file_location(f"jax_{name}", REPO / "tools" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_trace_smoke_twin_on_the_cpu(capsys):
    assert trace_smoke.main(["--device", "cpu"]) == 0
    lines = [json.loads(x) for x in capsys.readouterr().out.strip().splitlines()
             if x.startswith("{")]
    one, two = lines[-2], lines[-1]
    assert one["trace_smoke"] == "ok" and one["device"] == "cpu"
    assert two["trace_smoke_2node"] == "ok" and two["nodes"] == ["val-0", "val-1"]
    assert two["cross_node_flows"] >= 1
    # each validator extended the block once (cold): no launch on the CPU
    assert [c["misses"] for c in two["node_counts"]] == [1, 1]


def node_parts(tmp_path):
    """Two nodes' trace parts: one traced block each, the second node's
    clock 1 ms ahead."""
    from celestia_tpu_torch.utils import tracing

    tracing.enable(4)
    tracing.clear()
    try:
        with tracing.block_span("prepare_proposal", 1):
            with tracing.span("extend", k=2):
                pass
        dump = tracing.trace_dump()
    finally:
        tracing.disable()
        tracing.clear()
    paths = []
    for i, offset in enumerate((0.0, 0.001)):
        p = tmp_path / f"node{i}.json"
        p.write_text(json.dumps({"node_id": f"val-{i}", "clock_offset_s": offset,
                                 "trace": dump}))
        paths.append(str(p))
    return paths


def test_trace_merge_twin_merges_as_the_jax_tool(tmp_path, capsys):
    paths = node_parts(tmp_path)
    jax_out, port_out = tmp_path / "jax.json", tmp_path / "port.json"
    assert _jax_tool("trace_merge").main([*paths, "-o", str(jax_out)]) == 0
    assert trace_merge.main([*paths, "-o", str(port_out)]) == 0
    assert json.loads(port_out.read_text()) == json.loads(jax_out.read_text())
    summaries = [json.loads(x) for x in capsys.readouterr().out.strip().splitlines()]
    assert summaries[1]["nodes"] == ["val-0", "val-1"]
    assert {k: v for k, v in summaries[0].items() if k != "merged"} == (
        {k: v for k, v in summaries[1].items() if k != "merged"})
    # an unreadable input exits 1 with the reason
    bad = tmp_path / "bad.json"
    bad.write_text("[]")
    assert trace_merge.main([str(bad), "-o", str(tmp_path / "x.json")]) == 1
