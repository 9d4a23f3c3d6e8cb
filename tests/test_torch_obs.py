"""The port's host observability (``celestia_tpu_torch/utils/{hostprof,
timeseries, critpath, flight, lockwatch}.py``) against the JAX package's
modules on the same inputs, and the ``CELESTIA_TPU_TORCH_LOCKWATCH`` hook
of the port's ``__init__`` in a fresh interpreter.  Wall-clock values
(sample times, uptimes, ids carrying them) are left out of the
comparisons; each test names what it masks."""

import json
import subprocess
import sys
import threading
import time
from pathlib import Path

import pytest

from celestia_tpu.utils import critpath as jax_critpath
from celestia_tpu.utils import flight as jax_flight
from celestia_tpu.utils import hostprof as jax_hostprof
from celestia_tpu.utils import lockwatch as jax_lockwatch
from celestia_tpu.utils import timeseries as jax_ts
from celestia_tpu_torch.utils import critpath, flight, hostprof, lockwatch, timeseries, tracing

ROOT = Path(__file__).resolve().parents[1]


def _families(lines) -> list:
    return sorted({line.split("{")[0].split(" ")[0] for line in lines if not line.startswith("#")})


def test_hostprof_matches_jax():
    frame = sys._getframe()
    assert hostprof._frame_stack(frame) == jax_hostprof._frame_stack(frame)
    stats = []
    for mod in (jax_hostprof, hostprof):
        mod.clear()
        mod.start(200.0)
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < 0.2:
            sum(range(1000))
        mod.stop()
        stats.append(mod.stats())
        assert mod.samples() and mod.folded_stacks() and mod.top_frames(3)
        assert tracing.validate_chrome_trace(mod.merged_trace_dump()) == []
    # masked: the sample counts and measured overheads (the sampler's timing)
    assert set(stats[1]) == set(stats[0])
    assert _families(hostprof.exposition_lines()) == _families(jax_hostprof.exposition_lines())
    for mod in (jax_hostprof, hostprof):
        mod.clear()


SERIES = [(100.0 + 5 * i, {"height": float(i), "das_shed": float(3 * i * i),
                           "device_occupancy_pct": 40.0 + i, "fault_notes": float(i // 2)})
          for i in range(8)]
RULES = json.dumps([
    {"name": "shed_fast", "metric": "das_shed", "kind": "rate", "op": ">", "threshold": 1.0,
     "for_s": 10.0},
    {"name": "busy", "metric": "device_occupancy_pct", "op": ">=", "threshold": 45.0},
])


def _series(mod):
    ts = mod.TimeSeries(16)
    for t, values in SERIES:
        ts.record(values, ts=t)
    return ts


def test_timeseries_rules_and_slos_match_jax(monkeypatch):
    ref, port = _series(jax_ts), _series(timeseries)
    assert port.samples() == ref.samples()
    assert port.rates() == ref.rates() and port.rates(12.0) == ref.rates(12.0)
    assert port.delta("das_shed", 10.0) == ref.delta("das_shed", 10.0)
    assert port.latest("height") == ref.latest("height")
    for rules in ((jax_ts.default_rules(), timeseries.default_rules()),
                  (jax_ts.rules_from_json(RULES), timeseries.rules_from_json(RULES))):
        assert [r.to_dict() for r in rules[1]] == [r.to_dict() for r in rules[0]]
        engines = [mod.AlertEngine(rs) for mod, rs in zip((jax_ts, timeseries), rules)]
        assert engines[1].evaluate(port) == engines[0].evaluate(ref)
    assert ([s.to_dict() for s in timeseries.default_slos()]
            == [s.to_dict() for s in jax_ts.default_slos()])
    assert ([s.evaluate(port) for s in timeseries.default_slos()]
            == [s.evaluate(ref) for s in jax_ts.default_slos()])
    # each package reads its own switch
    monkeypatch.setenv("CELESTIA_TPU_TORCH_ALERT_RULES", RULES)
    monkeypatch.delenv("CELESTIA_TPU_ALERT_RULES", raising=False)
    assert [r.name for r in timeseries.rules_from_env()] == ["shed_fast", "busy"]
    assert jax_ts.rules_from_env() == []


def _traced_doc() -> dict:
    """A block's trace on the port's tracer: a root span with host phases,
    a queue wait and a device span (the shape devprof records)."""
    from celestia_tpu_torch.utils import devprof

    tracing.enable(4)
    tracing.clear()
    try:
        with tracing.block_span("prepare_proposal", height=5):
            with tracing.span("filter_txs", txs=3):
                time.sleep(0.002)
            t0 = time.perf_counter()
            with tracing.span("extend.device_plane", k=2) as sp:
                time.sleep(0.003)
                tracing.record_span("device.extend_levels", t0, time.perf_counter(), parent=sp,
                                    cat="device", tid=devprof.DEVICE_TID_BASE,
                                    thread_name="device:cpu:0")
            tracing.record_span("queue_wait", t0, t0 + 0.001, render_async=True)
        return tracing.trace_dump()
    finally:
        tracing.disable()
        tracing.clear()


def test_critpath_matches_jax_on_the_same_trace():
    doc = _traced_doc()
    assert tracing.validate_chrome_trace(doc) == []
    assert critpath.critical_path(doc) == jax_critpath.critical_path(doc)
    assert critpath.critical_path(doc, height=5) == jax_critpath.critical_path(doc, height=5)
    assert critpath.propagation_delays(doc) == jax_critpath.propagation_delays(doc)


def test_flight_recorder_matches_jax(tmp_path, monkeypatch):
    # one node id for both packages, whatever server this worker ran before
    from celestia_tpu.utils import tracing as jax_tracing

    for mod in (jax_tracing, tracing):
        monkeypatch.setattr(mod, "_node_id", "flight-node")
    verdicts = [{"name": "shed_fast", "firing": True, "value": 2.0},
                {"name": "busy", "firing": False, "value": 1.0}]
    manifests = []
    for name, mod in (("jax", jax_flight), ("port", flight)):
        rec = mod.FlightRecorder(str(tmp_path / name), min_interval_s=0.0)
        inc = rec.on_alerts(verdicts, height=7, metrics_text="celestia_tpu_x 1\n",
                            timeseries_snapshots=[{"ts": 1.0, "values": {"height": 7.0}}])
        assert inc == "inc-000001-alert-shed_fast"
        assert rec.on_alerts(verdicts, height=8) is None  # no new transition
        assert rec.trigger("manual", height=9) == "inc-000002-manual"
        listed = rec.list_incidents()
        bundle = rec.load_bundle(inc)
        assert mod.validate_manifest(bundle["manifest"]) == []
        # the other package's validator accepts it too
        other = flight if mod is jax_flight else jax_flight
        assert other.validate_manifest(bundle["manifest"]) == []
        # masked: the wall-clock stamps, the directory, and the sizes and
        # digests of files that carry stamps or each package's own state
        manifests.append((
            [{k: v for k, v in m.items() if k not in ("ts", "total_bytes")} for m in listed],
            [f["name"] for f in bundle["manifest"]["files"]],
            sorted(bundle["files"]),
            json.loads(bundle["files"]["alerts.json"]),
            {k: v for k, v in rec.stats().items() if k not in ("dir", "total_bytes")},
        ))
    assert manifests[1] == manifests[0]


def test_lockwatch_finds_the_same_inversion_as_jax():
    reports = []
    for mod in (jax_lockwatch, lockwatch):
        mod.reset()
        a = mod.watched(site=("pkg/a.py", 1))
        b = mod.watched(site=("pkg/b.py", 2))
        mod.arm()
        try:
            with a:
                with b:
                    pass

            def other_order():
                with b:
                    with a:
                        pass

            t = threading.Thread(target=other_order)
            t.start()
            t.join(timeout=10)
            assert not t.is_alive()
            pairs = sorted(mod.observed_pairs())
            invs = [(i["first"], i["second"]) for i in mod.inversions()]
            # masked: the acquisition stacks (file paths of each package)
            reports.append((pairs, invs, mod.report().splitlines()[0]))
        finally:
            mod.disarm()
            mod.reset()
    assert reports[1] == reports[0]
    assert reports[1][1] == [(("pkg/b.py", 2), ("pkg/a.py", 1))]


@pytest.mark.parametrize("armed", [True, False])
def test_the_lockwatch_hook_arms_at_import(armed):
    code = (
        "import threading\n"
        "real = threading.Lock\n"
        "import celestia_tpu_torch\n"
        "from celestia_tpu_torch.utils import lockwatch, lru\n"
        "print(lockwatch.installed(), lockwatch.armed(), threading.Lock is not real,\n"
        "      type(lru._registry_lock).__name__ if hasattr(lru, '_registry_lock') else '')\n"
    )
    env = {"PATH": "/usr/bin:/bin", "JAX_PLATFORMS": "cpu"}
    # the JAX package's switch never arms the port's watcher
    env["CELESTIA_TPU_LOCKWATCH"] = "1"
    if armed:
        env["CELESTIA_TPU_TORCH_LOCKWATCH"] = "1"
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env, capture_output=True,
                         text=True, timeout=60)
    assert out.returncode == 0, out.stderr
    installed, is_armed, swapped = out.stdout.split()[:3]
    assert (installed, is_armed, swapped) == ((str(armed),) * 3)
