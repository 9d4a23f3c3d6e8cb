"""profile-smoke: the DEVICE observability plane's boot gate, on the port.

Twin of ``tools/profile_smoke.py``, on the device (``cuda:0``, or
``--device cpu``).

Leg 1 (single process): one tiny-k TestNode block on the device with
tracing AND the device track armed, under a ``torch.profiler`` capture
(the JAX tool's XLA profile), and asserts:

* the merged Chrome trace is schema-valid and contains HOST spans and
  at least one DEVICE-track event for the same height (the plane's
  dispatch spans inside the prepare block trace, on the
  ``device:cuda:0`` track).  A TestNode on the CPU runs the host regime
  and dispatches nothing, so with ``--device cpu`` the leg calls the
  plane directly on the committed block's square, in a traced block of
  its own (``device:cpu:0``), and holds its data root to the block's;
* the cost table recorded the plane's extension (``extend_levels``), and
  the capture wrote a Chrome trace with events,
* a time-series ring over the node yields >= 2 snapshots whose dump is
  JSON-parseable with computed rates,
* a deliberately-tripped alert rule fires (a recorded degradation
  drives the stock `degradations` rule),
* the node's full Prometheus exposition (incl. the
  celestia_tpu_device_* / celestia_tpu_kernel_* / celestia_tpu_alert_*
  sections) parses line by line.

Leg 2 (one node subprocess): starts a traced validator (no
self-production — a synthetically HEIGHT-STALLED node) with the
plain-HTTP /metrics endpoint, an operator alert rule injected via
CELESTIA_TPU_TORCH_ALERT_RULES, and a fast sampler cadence; then drives the
REAL CLI — `query timeseries` must return >= 2 snapshots with computed
rates, `query alerts` must show the tripped stall rule — and scrapes
GET /metrics over plain HTTP, asserting the exposition parses and
carries the firing alert gauge.

Exit 0 + one summary JSON line per leg (with the device and the node's
launch counts) on success; 1 with the reason on any failure.

    python -m celestia_tpu_torch.tools.profile_smoke [--device cpu]
"""

import json
import os
import signal
import subprocess
import sys
import tempfile
import time
import urllib.request

from celestia_tpu_torch import tools

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

SMOKE_RULE = {
    "name": "smoke_height_stall",
    "metric": "height",
    "kind": "stall",
    "for_s": 0.5,
}


def leg1(device: str) -> int:
    import numpy as np

    from celestia_tpu_torch.client.signer import Signer
    from celestia_tpu_torch.da import device_plane, eds_cache
    from celestia_tpu_torch.node.server import NodeService
    from celestia_tpu_torch.node.testnode import TestNode
    from celestia_tpu_torch.state.tx import MsgSend
    from celestia_tpu_torch.utils import devprof, faults, timeseries, tracing
    from celestia_tpu_torch.utils.secp256k1 import PrivateKey
    from celestia_tpu_torch.utils.telemetry import validate_exposition

    on_card = device.startswith("cuda")
    tracing.enable(4)
    tracing.clear()
    devprof.reset()
    eds_cache.clear()
    capture_dir = tempfile.mkdtemp(prefix="profile-smoke-capture-")
    # the torch.profiler capture (the JAX tool's XLA profile): CPU activity,
    # and the card's when there is one
    devprof.start_profiler(capture_dir)
    try:
        key = PrivateKey.from_seed(b"profile-smoke")
        node = TestNode(
            funded_accounts=[(key, 10**12)], auto_produce=False, device=device
        )
        signer = Signer(node, key)
        res = signer._broadcast(
            lambda: signer.sign_tx(
                [MsgSend(signer.address, b"\x22" * 20, 1000)]
            ).marshal()
        )
        if res.code != 0:
            print(f"profile-smoke: broadcast failed: {res.log}", file=sys.stderr)
            return 1
        node.produce_block()
        if on_card:
            # the block's extension ran on the card through the plane
            leg_name = "prepare_proposal"
        else:
            # a TestNode on the CPU runs the host regime, which dispatches
            # nothing: the device-track leg calls the plane directly, in a
            # traced block of its own, on the committed block's square
            leg_name = "plane_extend"
            art = node._block_artifacts(node.height)
            k = art["square"].size
            square = np.asarray(art["square"].to_array()).reshape(k, k, -1)
            with tracing.block_span(leg_name, node.height):
                _, dah = device_plane.extend_and_header(square, device="cpu")
            if dah.hash != node.block(node.height).header.data_hash:
                print("profile-smoke: the plane's data root differs from the "
                      "block's", file=sys.stderr)
                return 1
    finally:
        capture = devprof.stop_profiler()

    traces = tracing.block_traces()
    prep = [t for t in traces if t.name == leg_name]
    if not prep:
        print(f"profile-smoke: no {leg_name} trace", file=sys.stderr)
        return 1
    prep = prep[-1]
    host_spans = [s for s in prep.spans if s.cat != "device"]
    device_spans = [s for s in prep.spans if s.cat == "device"]
    if not host_spans:
        print(f"profile-smoke: {leg_name} trace has no host spans", file=sys.stderr)
        return 1
    if not device_spans:
        print(
            f"profile-smoke: no device-track span in the {leg_name} trace "
            f"(spans: {sorted({s.name for s in prep.spans})})",
            file=sys.stderr,
        )
        return 1
    for s in device_spans:
        if s.tid < devprof.DEVICE_TID_BASE or not s.thread_name.startswith(
            "device:"
        ):
            print(
                f"profile-smoke: device span {s.name} not on a device "
                f"track (tid={s.tid}, thread={s.thread_name!r})",
                file=sys.stderr,
            )
            return 1

    # the merged host+device doc must stay a valid Chrome trace and the
    # device track must surface as a named Perfetto thread
    dump = tracing.trace_dump()
    problems = tracing.validate_chrome_trace(dump)
    if problems:
        print(f"profile-smoke: invalid trace JSON: {problems[:5]}", file=sys.stderr)
        return 1
    thread_names = {
        ev["args"]["name"]
        for ev in dump["traceEvents"]
        if ev.get("ph") == "M" and ev.get("name") == "thread_name"
    }
    want_track = "device:" + ("cuda:0" if on_card else "cpu:0")
    if want_track not in thread_names:
        print(
            f"profile-smoke: no {want_track} thread_name metadata ({thread_names})",
            file=sys.stderr,
        )
        return 1

    # the cost table recorded the plane's extension
    prof = devprof.device_profile()
    if "extend_levels" not in prof["kernels"]:
        print(
            f"profile-smoke: no cost row for extend_levels "
            f"(kernels: {sorted(prof['kernels'])}, notes: {prof['notes']})",
            file=sys.stderr,
        )
        return 1

    # the torch.profiler capture: a Chrome trace with events
    with open(capture) as f:
        captured = json.load(f)
    if not captured.get("traceEvents"):
        print(f"profile-smoke: empty torch.profiler capture {capture}",
              file=sys.stderr)
        return 1

    # time series: >= 2 snapshots, parseable dump, computed rates
    series = timeseries.TimeSeries(16)
    series.record(timeseries.collect_node_sample(node))
    # deliberately degrade the node so the stock rule trips
    faults.record_degradation("profile_smoke", "deliberate alert trip")
    time.sleep(0.05)
    series.record(timeseries.collect_node_sample(node))
    snapshots = series.samples()
    if len(snapshots) < 2:
        print(f"profile-smoke: only {len(snapshots)} snapshots", file=sys.stderr)
        return 1
    rates = series.rates()
    json.loads(json.dumps({"snapshots": snapshots, "rates": rates}))
    if "height" not in rates:
        print(f"profile-smoke: no computed rates ({sorted(rates)})", file=sys.stderr)
        return 1

    engine = timeseries.AlertEngine(timeseries.default_rules())
    firing = engine.firing(series)
    if not any(a["name"] == "degradations" for a in firing):
        print(
            f"profile-smoke: tripped rule did not fire (firing: "
            f"{[a['name'] for a in firing]})",
            file=sys.stderr,
        )
        return 1

    # the full exposition (incl. device/kernel/alert sections) must parse
    service = NodeService(node)
    service.timeseries = series
    text = service.metrics_text()
    bad = validate_exposition(text)
    if bad:
        print(
            f"profile-smoke: malformed exposition lines: {bad[:3]!r}",
            file=sys.stderr,
        )
        return 1

    print(
        json.dumps(
            {
                "profile_smoke": "ok",
                "device": device,
                "height": node.height,
                "device_leg": leg_name,
                "device_spans": len(device_spans),
                "device_tracks": sorted(
                    n for n in thread_names if n.startswith("device:")
                ),
                "kernels": sorted(prof["kernels"]),
                "capture_events": len(captured["traceEvents"]),
                "snapshots": len(snapshots),
                "alerts_fired": [a["name"] for a in firing],
                "node_counts": [tools.exposition_counts(text)],
            }
        )
    )
    return 0




def leg2(device: str) -> int:
    from celestia_tpu_torch.utils.telemetry import validate_exposition

    base = tempfile.mkdtemp(prefix="profile-smoke-")
    env = {
        **os.environ,
        "CELESTIA_TPU_TORCH_DEVICE": device,
        "CELESTIA_TPU_TORCH_TRACE": "1",
        "CELESTIA_TPU_TORCH_ALERT_RULES": json.dumps([SMOKE_RULE]),
    }
    home = os.path.join(base, "node")
    r = subprocess.run(
        [
            sys.executable, "-m", "celestia_tpu_torch.cli",
            "--home", home, "init", "--chain-id", "profile-smoke-1",
        ],
        capture_output=True, text=True, timeout=120, cwd=REPO, env=env,
    )
    if r.returncode != 0:
        print(f"profile-smoke-node: init failed: {r.stderr}", file=sys.stderr)
        return 1
    proc = subprocess.Popen(
        [
            sys.executable, "-m", "celestia_tpu_torch.cli",
            "--home", home, "start", "--validator",
            "--grpc-address", "127.0.0.1:0",
            "--metrics-port", "0",
            "--timeseries-interval", "0.2",
            "--warm-squares", "",
        ],
        stdout=subprocess.PIPE, stderr=subprocess.DEVNULL,
        text=True, cwd=REPO,
        env={**env, "CELESTIA_TPU_TORCH_NODE_ID": "profile-smoke-node"},
    )
    try:
        line = tools.readline_deadline(proc)
        if line is None or proc.poll() is not None:
            why = "died" if proc.poll() is not None else "hung"
            print(f"profile-smoke-node: validator {why} at startup",
                  file=sys.stderr)
            return 1
        started = json.loads(line)
        addr, http_addr = started["grpc"], started.get("metrics_http")
        if not http_addr:
            print("profile-smoke-node: no metrics_http in startup line",
                  file=sys.stderr)
            return 1
        # a validator that nothing drives produces no blocks: the injected
        # stall rule needs its for_s of flat samples
        time.sleep(1.2)

        def cli(*args):
            return subprocess.run(
                [sys.executable, "-m", "celestia_tpu_torch.cli", *args],
                capture_output=True, text=True, timeout=120,
                cwd=REPO, env=env,
            )

        # the REAL CLI surface: query timeseries (called twice via the
        # alerts query too, so >= 2 on-demand samples are guaranteed
        # even if the sampler thread lost every race)
        ts = cli("query", "--node", addr, "timeseries")
        if ts.returncode != 0:
            print(f"profile-smoke-node: query timeseries failed: {ts.stderr}",
                  file=sys.stderr)
            return 1
        ts_doc = json.loads(ts.stdout)
        if len(ts_doc["snapshots"]) < 2:
            print(
                f"profile-smoke-node: {len(ts_doc['snapshots'])} snapshots "
                "(need >= 2)",
                file=sys.stderr,
            )
            return 1
        if "height" not in ts_doc["rates"]:
            print(f"profile-smoke-node: no computed rates: {ts_doc['rates']}",
                  file=sys.stderr)
            return 1
        al = cli("query", "--node", addr, "alerts", "--firing-only")
        if al.returncode != 0:
            print(f"profile-smoke-node: query alerts failed: {al.stderr}",
                  file=sys.stderr)
            return 1
        al_doc = json.loads(al.stdout)
        fired = {a["name"] for a in al_doc["alerts"]}
        if SMOKE_RULE["name"] not in fired:
            print(
                f"profile-smoke-node: stall rule not firing (fired: "
                f"{sorted(fired)})",
                file=sys.stderr,
            )
            return 1
        # the plain-HTTP scrape: parse-valid and carrying the alert gauge
        body = urllib.request.urlopen(
            f"http://{http_addr}/metrics", timeout=30
        ).read().decode()
        bad = validate_exposition(body)
        if bad:
            print(
                f"profile-smoke-node: malformed HTTP exposition: {bad[:3]!r}",
                file=sys.stderr,
            )
            return 1
        want = 'celestia_tpu_alert_firing{rule="%s"} 1' % SMOKE_RULE["name"]
        if want not in body:
            print(f"profile-smoke-node: {want!r} missing from the scrape",
                  file=sys.stderr)
            return 1
        print(
            json.dumps(
                {
                    "profile_smoke_node": "ok",
                    "device": device,
                    "node_counts": [tools.exposition_counts(body)],
                    "grpc": addr,
                    "metrics_http": http_addr,
                    "snapshots": len(ts_doc["snapshots"]),
                    "alerts_fired": sorted(fired),
                    "scrape_bytes": len(body),
                }
            )
        )
        return 0
    finally:
        proc.send_signal(signal.SIGINT)
        try:
            proc.wait(timeout=10)
        except subprocess.TimeoutExpired:
            proc.kill()


LEGS = {"node": leg1, "cli": leg2}


def main(argv=None) -> int:
    return tools.run_legs("profile_smoke", LEGS, argv, __doc__)


if __name__ == "__main__":
    sys.exit(main())
